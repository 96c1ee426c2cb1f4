// The LSTM recurrence of nbasr_torch/models/lstm.py FastLSTM, for Hopper
// (sm_90a): one persistent launch walks every frame forward, one walks them
// back.
//
// Replaces no TPU kernel.  nbasr_tpu/models/lstm.py FastLSTM runs the
// recurrence as a lax.scan that XLA compiles into one loop on the TPU; the
// port ran it as a Python loop of about 14 PyTorch launches a frame, and
// autograd added about 23 more a frame for the backward: 81% of a flagship
// train step's launches and 84% of a serving step's.  These two kernels put
// the loop on the card, so a call launches once each way whatever T is.
//
// What they compute, for xw [B, T, 4H] (x @ kernel + bias, gate order i, f,
// g, o), rec [H, 4H] and the carry (c, h), in the compute dtype E (float or
// bf16) with f32 sums:
//   forward, t = 0..T-1:
//     a = E(xw[t] + E(h @ rec)); i, f, o = sigmoid(a_i, a_f, a_o), g = tanh(a_g)
//     c = E(f * c + i * g); h = E(o * tanh(c)); out[t] = h
//   with grad: acts[t] = E(i, f, g, o) and cs[t] = c, for the backward;
//   backward, t = T-1..0, from dout, the carry's incoming (dc, dh) and
//   dh_t = dout[t] + (dgates[t+1] @ rec^T, or the incoming dh at T-1):
//     dc += dh * o * (1 - tanh(c)^2); dgates[t] = E(dc * g * i(1-i),
//     dc * c_prev * f(1-f), dc * i * (1-g^2), dh * tanh(c) * o(1-o)); dc *= f
//   then dc0 = dc, dh0 = dgates[0] @ rec^T.
// Everything that is not serial stays outside: the input projection before,
// and drec = h_prev^T @ dgates, dxw = dgates after (matrix products in
// nbasr_torch/ops/lstm_recurrence.py).  The plain versions there hold the
// same arithmetic; these round c and h once a frame, where the loop rounds
// after each elementwise op in bf16.
//
// Bound on an H100 SXM: neither bytes nor operations but the chain of T
// dependent frames.  A frame needs all of h_{t-1} (B x H) in every block, so
// it costs at least one grid-wide barrier and one L2 read of h (or of
// dgates, B x 4H, backward), ~1 us each; its 2*B*H*4H flops (128 MFLOP at
// B=64, H=500) take 0.13 us on the bf16 tensor cores, 2 us on the f32 pipes.
// The bytes of a call (xw once, out once) are ~10 us of a 196-frame call at
// 3.35 TB/s.
//
// Design: one cooperative grid of at most one block per SM, each block a
// slice of units ([u0, u0+U)) for a slice of batch rows ([b0, b0+BB)),
// planned in Python (lstm_recurrence.recurrence_plan) and checked here.  The
// block's columns of rec (forward: the 4U gate columns of its units, all H
// rows; backward: its U rows of rec, all 4H columns) come in a layout made
// in Python (rec_blocks: [Kp rows, Cp columns] f32 per block) and stay in
// shared memory for the whole sequence (streamed from L2 each frame where
// they do not fit; f32 only).  Per frame the block stages its rows of
// h_{t-1} (or dgates_{t+1}) from L2 into shared memory (ld.cg: other blocks
// wrote them; four elements a load, every load of a thread in flight at
// once), in tiles of BT rows, and sums the tile's product with its slice:
//   - bf16 (mma): rec transposed to bf16 once, h as it is; each warp runs
//     mma.sync m16n8k16 (bf16 operands, f32 sums) over every S-th k step of
//     a 16 x 8 output tile, fragments by ldmatrix;
//   - f32: f32 FMAs (no TF32), each thread a 4 x 4 output tile over every
//     S-th quad of k, float4 reads of both operands.
// The S partials meet in shared memory and the apply step reads them in a
// fixed order (bit-equal across calls); it adds xw and applies the gates in
// f32, one (row, unit) a thread, its global operands loaded before the tile
// is staged.  The running c (forward) or dc (backward, f32 scratch) of a
// unit stays in global memory read and written by one thread.  Then the
// grid meets at one barrier: each block publishes its frame count in a flag
// of its own (st.release) and block threads poll one flag each
// (ld.acquire), so no two blocks contend for one address.
//
// Both entry points run on the caller's stream and return the cudaError_t
// of their launch.  A barrier that waits longer than any run could traps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBatch = 16;                 // loads in flight a thread when staging
constexpr long long kSpinLimit = 1LL << 26;     // polls before a trap (seconds)

// The launch plan, in lstm_recurrence.PLAN_FIELDS order.
struct Plan {
  int U, nb_u, BB, nb_b, BT, S, Kp, Cp, ld, rec_smem, mma, smem;
};
constexpr int kPlanInts = 12;

using bf16 = __nv_bfloat16;

template <typename E>
struct Elem;

template <>
struct Elem<float> {
  using Raw = float;
  using Raw4 = float4;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ Raw load_cg(const float* p) { return __ldcg(p); }
  static __device__ __forceinline__ Raw4 load4_cg(const float* p) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float to_float(Raw v) { return v; }
  static __device__ __forceinline__ float4 to_float4(Raw4 v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Elem<bf16> {
  using Raw = unsigned short;
  using Raw4 = uint2;
  static __device__ __forceinline__ float bits(unsigned b) { return __uint_as_float(b << 16); }
  static __device__ __forceinline__ float load(const bf16* p) {
    return bits(*reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ Raw load_cg(const bf16* p) {
    return __ldcg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ Raw4 load4_cg(const bf16* p) {
    return __ldcg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float to_float(Raw v) { return bits(v); }
  static __device__ __forceinline__ float4 to_float4(Raw4 v) {
    return make_float4(bits(v.x & 0xffffu), bits(v.x >> 16), bits(v.y & 0xffffu), bits(v.y >> 16));
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
};

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Every block of the grid arrives before any leaves; the block's writes
// before it are visible to every block after it (ld.cg reads).  Block b
// publishes `epoch` (the barriers so far, from 1) in flags[b]; thread j of
// every block waits for flags[j].
__device__ __forceinline__ void grid_sync(unsigned* flags, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(flags + blockIdx.x), "r"(epoch) : "memory");
  }
  if (threadIdx.x < gridDim.x) {
    unsigned seen;
    long long spins = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(flags + threadIdx.x) : "memory");
      if (seen >= epoch) break;
      if (++spins > kSpinLimit) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// staging: op [BT rows, ld apart] <- rows r < rows of the source (row r at
// src + r * stride), columns k < K; zero up to `width` columns and in rows
// past `rows`; as f32 (S = float, the FMA path) or as the bits they are (S
// = E, the mma path).  Four elements a load where K % 4 == 0.  Every load
// of a thread's batch is issued before any is used (an unused one reads
// the first row, which always exists).
// ---------------------------------------------------------------------------

template <typename E, typename S>
__device__ __forceinline__ void stage(S* op, int BT, int ld, int width, int rows, int K,
                                      const E* src, size_t stride) {
  using X = Elem<E>;
  constexpr bool kConvert = std::is_same_v<S, float>;
  const int v = K % 4 == 0 ? 4 : 1;      // elements a load
  const int per_row = width / v, n = BT * per_row;
  for (int base = threadIdx.x; base < n; base += kThreads * kStageBatch) {
    typename X::Raw4 raw4[kStageBatch];
    typename X::Raw raw[kStageBatch];
    bool ok[kStageBatch];
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int idx = base + j * kThreads;
      const int r = idx / per_row, k = v * (idx - r * per_row);
      ok[j] = idx < n && r < rows && k < K;
      const E* at = ok[j] ? src + r * stride + k : src;
      if (v == 4)
        raw4[j] = X::load4_cg(at);
      else
        raw[j] = X::load_cg(at);
    }
#pragma unroll
    for (int j = 0; j < kStageBatch; ++j) {
      const int idx = base + j * kThreads;
      if (idx >= n) continue;
      const int r = idx / per_row, k = v * (idx - r * per_row);
      S* to = op + r * ld + k;
      if constexpr (kConvert) {
        if (v == 4)
          *reinterpret_cast<float4*>(to) = ok[j] ? X::to_float4(raw4[j]) : float4{};
        else
          *to = ok[j] ? X::to_float(raw[j]) : 0.f;
      } else {
        if (v == 4)
          *reinterpret_cast<typename X::Raw4*>(to) = ok[j] ? raw4[j] : typename X::Raw4{};
        else
          *reinterpret_cast<typename X::Raw*>(to) = ok[j] ? raw[j] : typename X::Raw{};
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tile's product with the block's slice of rec, as S partials a tile
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fma4(float* acc, float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// f32: op [rows4 * 4 rows, ld apart] x rec [Kp, Cp]; work item w = s *
// tiles + tile (tiles: the plan's BT/4 x Cp/4), tile (tr, tc) = 4 rows x 4
// columns; split s sums the k quads s, s+S, ... in order and stores its 16
// partials at red[16 w], row-major.  Neighbouring threads take neighbouring
// tiles of one split: a quarter-warp's float4 reads of rec then fall in
// distinct banks.
__device__ __forceinline__ void gemm_fma(const float* __restrict__ op, const float* __restrict__ rec,
                                         float* __restrict__ red, int rows4, const Plan& p) {
  const int tiles_c = p.Cp / 4, tiles = (p.BT / 4) * tiles_c, quads = p.Kp / 4;
  for (int w = threadIdx.x; w < tiles * p.S; w += kThreads) {
    const int s = w / tiles, tile = w - s * tiles;
    const int tr = tile / tiles_c, tc = tile - tr * tiles_c;
    if (tr >= rows4) continue;
    const float* a = op + 4 * tr * p.ld;
    const float* b = rec + 4 * tc;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int q = s; q < quads; q += p.S) {
      const int k = 4 * q;
      float4 av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * p.ld + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (k + j) * p.Cp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(acc[i], av[i].x, bv[0]);
        fma4(acc[i], av[i].y, bv[1]);
        fma4(acc[i], av[i].z, bv[2]);
        fma4(acc[i], av[i].w, bv[3]);
      }
    }
    float4* out = reinterpret_cast<float4*>(red + 16 * w);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_step(float* c, const bf16* a, const bf16* b) {
  unsigned af[4], bfr[2];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(af[0]), "=r"(af[1]), "=r"(af[2]), "=r"(af[3])
               : "r"(smem_addr(a)));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(bfr[0]), "=r"(bfr[1])
               : "r"(smem_addr(b)));
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]), "r"(bfr[0]), "r"(bfr[1]));
}

// bf16: op [mtiles * 16 rows, ld apart] x recT [Cp rows (= N), ld apart]^T;
// work item w = s * tiles + tile (one warp; tiles: the plan's BT/16 x
// Cp/8), tile (mt, nt) = 16 rows x 8 columns; split s runs the k steps (16
// wide) s, s+S, ... on two accumulators in turn and stores their sum, 128
// partials at red[128 w], row-major.
__device__ __forceinline__ void gemm_mma(const bf16* op, const bf16* recT, float* red, int mtiles,
                                         const Plan& p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = p.Cp / 8, tiles = (p.BT / 16) * ntiles, steps = p.Kp / 16;
  for (int w = warp; w < tiles * p.S; w += kWarps) {
    const int s = w / tiles, tile = w - s * tiles;
    const int mt = tile / ntiles, nt = tile - mt * ntiles;
    if (mt >= mtiles) continue;
    const bf16* a = op + (16 * mt + lane % 16) * p.ld + (lane / 16) * 8;
    const bf16* b = recT + (8 * nt + lane % 8) * p.ld + ((lane / 8) % 2) * 8;
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    int ks = s;
    for (; ks + p.S < steps; ks += 2 * p.S) {
      mma_step(c0, a + 16 * ks, b + 16 * ks);
      mma_step(c1, a + 16 * (ks + p.S), b + 16 * (ks + p.S));
    }
    if (ks < steps) mma_step(c0, a + 16 * ks, b + 16 * ks);
    float* out = red + 128 * w;
    const int row = lane / 4, col = 2 * (lane % 4);
    out[row * 8 + col] = c0[0] + c1[0];
    out[row * 8 + col + 1] = c0[1] + c1[1];
    out[(row + 8) * 8 + col] = c0[2] + c1[2];
    out[(row + 8) * 8 + col + 1] = c0[3] + c1[3];
  }
}

// The sum of output (r, c): its tile's S partials, in order.  Tiles of TR x
// TC outputs, `tiles_c` to a row of tiles, `tiles` in all.
template <int TR, int TC>
__device__ __forceinline__ float gemm_sum(const float* red, int r, int c, int tiles_c, int tiles,
                                          int S) {
  const int tile = (r / TR) * tiles_c + c / TC;
  const float* at = red + TR * TC * tile + TC * (r % TR) + c % TC;
  float sum = 0.f;
  for (int s = 0; s < S; ++s) sum += at[TR * TC * tiles * s];
  return sum;
}

// ---------------------------------------------------------------------------
// the block's shared memory: partials, op tile, then rec (if resident)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int red_floats(const Plan& p) {
  return p.mma ? 128 * (p.BT / 16) * (p.Cp / 8) * p.S : 16 * (p.BT / 4) * (p.Cp / 4) * p.S;
}

// Carves the shared memory and brings the block's slice of rec into it:
// f32 as it is, or transposed to bf16 for the mma path.
template <bool kMma>
__device__ __forceinline__ void carve(const Plan& p, const float* rec_blocks, float** red,
                                      void** op, const void** rec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  *red = smem;
  char* after = reinterpret_cast<char*>(smem + red_floats(p));
  *op = after;
  const size_t op_bytes = static_cast<size_t>(p.BT) * p.ld * (kMma ? 2 : 4);
  const int ug = blockIdx.x % p.nb_u;
  const float* g = rec_blocks + static_cast<size_t>(ug) * p.Kp * p.Cp;
  *rec = g;
  if (kMma) {
    bf16* rec_s = reinterpret_cast<bf16*>(after + op_bytes);
    for (int idx = threadIdx.x; idx < p.Kp * p.Cp; idx += kThreads) {
      const int k = idx / p.Cp, n = idx - k * p.Cp;
      rec_s[n * p.ld + k] = __float2bfloat16_rn(g[idx]);
    }
    *rec = rec_s;
  } else if (p.rec_smem) {
    float* rec_s = reinterpret_cast<float*>(after + op_bytes);
    const int n4 = p.Kp * p.Cp / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<float4*>(rec_s)[i] = reinterpret_cast<const float4*>(g)[i];
    *rec = rec_s;
  }
  __syncthreads();
}

// Stages rows [0, rows) (row r at src + r * stride, K columns) and sums
// their product with rec into red.
template <typename E, bool kMma>
__device__ __forceinline__ void tile_product(float* red, void* op, const void* rec, int rows, int K,
                                             const E* src, size_t stride, const Plan& p) {
  if constexpr (kMma) {
    stage(static_cast<E*>(op), p.BT, p.ld, p.Kp, rows, K, src, stride);
    __syncthreads();
    gemm_mma(static_cast<const bf16*>(op), static_cast<const bf16*>(rec), red, (rows + 15) / 16, p);
  } else {
    stage(static_cast<float*>(op), p.BT, p.ld, p.Kp, rows, K, src, stride);
    __syncthreads();
    gemm_fma(static_cast<const float*>(op), static_cast<const float*>(rec), red, (rows + 3) / 4, p);
  }
  __syncthreads();
}

template <bool kMma>
__device__ __forceinline__ float product_sum(const float* red, int r, int c, const Plan& p) {
  return kMma ? gemm_sum<16, 8>(red, r, c, p.Cp / 8, (p.BT / 16) * (p.Cp / 8), p.S)
              : gemm_sum<4, 4>(red, r, c, p.Cp / 4, (p.BT / 4) * (p.Cp / 4), p.S);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

template <typename E>
struct FwdArgs {
  Plan p;
  int B, T, H;
  const E* xw;           // [B, T, 4H]
  const float* rec;      // rec_blocks [nb_u, Kp, Cp]
  const E* c0;           // [B, H] or null (zeros)
  const E* h0;           // [B, H] or null (zeros)
  E* out;                // [B, T, H]
  E* c;                  // [B, H]: the running c, the final c
  E* h;                  // [B, H]: the final h
  E* acts;               // [B, T, 4H] or null (no saving)
  E* cs;                 // [B, T, H] or null
  unsigned* flags;       // one a block, zero at launch
};

template <typename E, bool kMma>
__global__ void __launch_bounds__(kThreads, 1) nbasr_lstm_fwd(const FwdArgs<E> a) {
  using X = Elem<E>;
  const Plan& p = a.p;
  const int H = a.H, T = a.T;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int ug = blockIdx.x % p.nb_u, bg = blockIdx.x / p.nb_u;
  const int u0 = ug * p.U, nu = min(p.U, H - u0);
  const int b0 = bg * p.BB, b1 = min(a.B, b0 + p.BB);
  float* red;
  void* op;
  const void* rec;
  carve<kMma>(p, a.rec, &red, &op, &rec);
  for (int t = 0; t < T; ++t) {
    const bool gemm = t > 0 || a.h0 != nullptr;
    for (int tb = b0; tb < b1; tb += p.BT) {
      const int rows = min(p.BT, b1 - tb);
      // this thread's (row, unit), its operands loaded before the tile
      const bool mine = threadIdx.x < rows * nu;
      const int r = mine ? threadIdx.x / nu : 0, u = mine ? threadIdx.x - r * nu : 0;
      const size_t b = tb + r, unit = u0 + u, row = b * T + t;
      float x[4], c_prev = 0.f;
      if (mine) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) x[gate] = X::load(a.xw + row * H4 + gate * H + unit);
        if (t > 0)
          c_prev = X::load(a.c + b * H + unit);
        else if (a.c0)
          c_prev = X::load(a.c0 + b * H + unit);
      }
      if (gemm) {
        const E* src = t == 0 ? a.h0 + tb * static_cast<size_t>(H)
                              : a.out + (static_cast<size_t>(tb) * T + t - 1) * H;
        tile_product<E, kMma>(red, op, rec, rows, H, src, t == 0 ? H : static_cast<size_t>(T) * H,
                              p);
      }
      if (mine) {
        float pre[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const float hr = gemm ? product_sum<kMma>(red, r, gate * p.U + u, p) : 0.f;
          pre[gate] = X::round(x[gate] + X::round(hr));
        }
        const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]), gg = tanhf(pre[2]),
                    og = sigmoid(pre[3]);
        const float c = X::round(fg * c_prev + ig * gg);
        const float h = X::round(og * tanhf(c));
        X::store(a.c + b * H + unit, c);
        X::store(a.out + row * H + unit, h);
        if (t == T - 1) X::store(a.h + b * H + unit, h);
        if (a.acts) {
          E* act = a.acts + row * H4 + unit;
          X::store(act, ig);
          X::store(act + H, fg);
          X::store(act + 2 * H, gg);
          X::store(act + 3 * H, og);
          X::store(a.cs + row * H + unit, c);
        }
      }
      __syncthreads();  // op and red serve the next tile
    }
    if (t + 1 < T) grid_sync(a.flags, t + 1);
  }
}

template <typename E>
struct BwdArgs {
  Plan p;
  int B, T, H;
  const E* acts;         // [B, T, 4H]
  const E* cs;           // [B, T, H]
  const float* rec;      // rec_blocks [nb_u, Kp, Cp] (rec's rows, transposed)
  const E* c0;           // [B, H] or null (zeros)
  const E* dout;         // [B, T, H] or null (zeros)
  const E* dc;           // [B, H] or null: the final c's gradient
  const E* dh;           // [B, H] or null: the final h's gradient
  E* dgates;             // [B, T, 4H]
  E* dc0;                // [B, H] or null (not wanted)
  E* dh0;                // [B, H] or null (not wanted)
  float* dcs;            // [B, H] f32: the running dc
  unsigned* flags;       // one a block, zero at launch
};

template <typename E, bool kMma>
__global__ void __launch_bounds__(kThreads, 1) nbasr_lstm_bwd(const BwdArgs<E> a) {
  using X = Elem<E>;
  const Plan& p = a.p;
  const int H = a.H, T = a.T;
  const size_t H4 = 4 * static_cast<size_t>(H);
  const int ug = blockIdx.x % p.nb_u, bg = blockIdx.x / p.nb_u;
  const int u0 = ug * p.U, nu = min(p.U, H - u0);
  const int b0 = bg * p.BB, b1 = min(a.B, b0 + p.BB);
  float* red;
  void* op;
  const void* rec;
  carve<kMma>(p, a.rec, &red, &op, &rec);
  unsigned epoch = 0;
  // t = -1 is dh0's pass: dgates[0] @ rec^T alone
  for (int t = T - 1; t >= (a.dh0 ? -1 : 0); --t) {
    const bool gemm = t < T - 1;
    for (int tb = b0; tb < b1; tb += p.BT) {
      const int rows = min(p.BT, b1 - tb);
      const bool mine = threadIdx.x < rows * nu;
      const int r = mine ? threadIdx.x / nu : 0, u = mine ? threadIdx.x - r * nu : 0;
      const size_t b = tb + r, unit = u0 + u, row = b * T + t;
      float act[4] = {0.f, 0.f, 0.f, 0.f}, c = 0.f, c_prev = 0.f, dh = 0.f, dc = 0.f;
      if (mine && t >= 0) {
        const E* at = a.acts + row * H4 + unit;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) act[gate] = X::load(at + gate * H);
        c = X::load(a.cs + row * H + unit);
        if (t > 0)
          c_prev = X::load(a.cs + (row - 1) * H + unit);
        else if (a.c0)
          c_prev = X::load(a.c0 + b * H + unit);
        if (a.dout) dh = X::load(a.dout + row * H + unit);
        if (gemm)
          dc = a.dcs[b * H + unit];
        else if (a.dc)
          dc = X::load(a.dc + b * H + unit);
      }
      if (gemm) {
        const E* src = a.dgates + (static_cast<size_t>(tb) * T + t + 1) * H4;
        tile_product<E, kMma>(red, op, rec, rows, static_cast<int>(H4), src,
                              static_cast<size_t>(T) * H4, p);
      }
      if (mine) {
        const float from_next = gemm ? product_sum<kMma>(red, r, u, p)
                                     : (a.dh ? X::load(a.dh + b * H + unit) : 0.f);
        if (t < 0) {
          X::store(a.dh0 + b * H + unit, from_next);
        } else {
          const float d_h = a.dout ? dh + from_next : from_next;
          const float ig = act[0], fg = act[1], gg = act[2], og = act[3];
          const float tc = tanhf(c);
          const float d_o = d_h * tc;
          dc = dc + d_h * og * (1.f - tc * tc);
          const float d_i = dc * gg, d_f = dc * c_prev, d_g = dc * ig;
          E* dg = a.dgates + row * H4 + unit;
          X::store(dg, d_i * ig * (1.f - ig));
          X::store(dg + H, d_f * fg * (1.f - fg));
          X::store(dg + 2 * H, d_g * (1.f - gg * gg));
          X::store(dg + 3 * H, d_o * og * (1.f - og));
          dc = dc * fg;
          a.dcs[b * H + unit] = dc;
          if (t == 0 && a.dc0) X::store(a.dc0 + b * H + unit, dc);
        }
      }
      __syncthreads();
    }
    if (t > 0 || (t == 0 && a.dh0)) grid_sync(a.flags, ++epoch);
  }
}

// ---------------------------------------------------------------------------
// the plan's checks and the launch
// ---------------------------------------------------------------------------

// The plan against the call's shape: `cols` gate columns per unit (4
// forward, 1 backward), K rows of rec's block layout; the mma path for bf16
// only (esize 2).
bool plan_ok(const Plan& p, int B, int H, int K, int cols, int esize) {
  if (p.U < 1 || p.nb_u != (H + p.U - 1) / p.U) return false;
  if (p.BB < 1 || p.nb_b != (B + p.BB - 1) / p.BB) return false;
  if (p.S < 1 || (p.S & (p.S - 1)) != 0 || p.mma < 0 || p.mma > 1) return false;
  if (p.BT < 1 || static_cast<long long>(p.BT) * p.U > kThreads) return false;
  long long floats = 0;
  if (p.mma) {
    if (esize != 2 || p.rec_smem != 1 || p.BT % 16 != 0) return false;
    if (p.Kp != (K + 15) / 16 * 16 || p.Cp != (cols * p.U + 7) / 8 * 8) return false;
    if (p.ld < p.Kp || p.ld % 8 != 0 || (p.ld / 8) % 2 != 1) return false;
    const long long tiles = static_cast<long long>(p.BT / 16) * (p.Cp / 8);
    if (p.S > 1 && tiles * p.S > kWarps) return false;
    floats = 128 * tiles * p.S + (static_cast<long long>(p.BT) * p.ld + p.Cp * p.ld) / 2;
  } else {
    if (p.rec_smem < 0 || p.rec_smem > 1 || p.BT % 4 != 0) return false;
    if (p.Kp != (K + 3) / 4 * 4 || p.Cp != (cols * p.U + 3) / 4 * 4) return false;
    if (p.ld < p.Kp || p.ld % 4 != 0) return false;
    const long long tiles = static_cast<long long>(p.BT / 4) * (p.Cp / 4);
    if (p.S > 1 && tiles * p.S > kThreads) return false;
    floats = 16 * tiles * p.S + static_cast<long long>(p.BT) * p.ld +
             (p.rec_smem ? static_cast<long long>(p.Kp) * p.Cp : 0);
  }
  return 4 * floats == p.smem;
}

template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const Args& args, cudaStream_t stream) {
  const Plan& p = args.p;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem)) !=
      cudaSuccess)
    return err;
  const int blocks = p.nb_u * p.nb_b;
  if (blocks > kThreads || blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  if ((err = cudaMemsetAsync(args.flags, 0, sizeof(unsigned) * blocks, stream)) != cudaSuccess)
    return err;
  void* params[] = {const_cast<Args*>(&args)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                     dim3(kThreads), params, static_cast<size_t>(p.smem), stream);
}

bool read_plan(const int* ints, Plan* p) {
  if (!ints) return false;
  int* out = reinterpret_cast<int*>(p);
  for (int i = 0; i < kPlanInts; ++i) out[i] = ints[i];
  return true;
}

template <typename E>
cudaError_t forward(int B, int T, int H, const Plan& p, const void* xw, const float* rec,
                    const void* c0, const void* h0, void* out, void* c, void* h, void* acts,
                    void* cs, unsigned* flags, cudaStream_t stream) {
  FwdArgs<E> a;
  a.p = p;
  a.B = B;
  a.T = T;
  a.H = H;
  a.xw = static_cast<const E*>(xw);
  a.rec = rec;
  a.c0 = static_cast<const E*>(c0);
  a.h0 = static_cast<const E*>(h0);
  a.out = static_cast<E*>(out);
  a.c = static_cast<E*>(c);
  a.h = static_cast<E*>(h);
  a.acts = static_cast<E*>(acts);
  a.cs = static_cast<E*>(cs);
  a.flags = flags;
  if constexpr (std::is_same_v<E, bf16>)
    if (p.mma) return launch(nbasr_lstm_fwd<E, true>, a, stream);
  return launch(nbasr_lstm_fwd<E, false>, a, stream);
}

template <typename E>
cudaError_t backward(int B, int T, int H, const Plan& p, const void* acts, const void* cs,
                     const float* rec, const void* c0, const void* dout, const void* dc,
                     const void* dh, void* dgates, void* dc0, void* dh0, float* dcs,
                     unsigned* flags, cudaStream_t stream) {
  BwdArgs<E> a;
  a.p = p;
  a.B = B;
  a.T = T;
  a.H = H;
  a.acts = static_cast<const E*>(acts);
  a.cs = static_cast<const E*>(cs);
  a.rec = rec;
  a.c0 = static_cast<const E*>(c0);
  a.dout = static_cast<const E*>(dout);
  a.dc = static_cast<const E*>(dc);
  a.dh = static_cast<const E*>(dh);
  a.dgates = static_cast<E*>(dgates);
  a.dc0 = static_cast<E*>(dc0);
  a.dh0 = static_cast<E*>(dh0);
  a.dcs = dcs;
  a.flags = flags;
  if constexpr (std::is_same_v<E, bf16>)
    if (p.mma) return launch(nbasr_lstm_bwd<E, true>, a, stream);
  return launch(nbasr_lstm_bwd<E, false>, a, stream);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (the mma plan only for bf16).  xw [B, T,
// 4H], rec_blocks [nb_u, Kp, Cp] f32 (lstm_recurrence.rec_blocks), c0 and
// h0 [B, H] or null (zeros) -> out [B, T, H], c and h [B, H] (the final
// carry), and with acts and cs (both or neither) what the backward reads.
// flags: one unsigned of scratch a block (nb_u * nb_b <= 256).
extern "C" int nbasr_lstm_forward(int dtype, int B, int T, int H, const int* plan_ints,
                                  const void* xw, const float* rec, const void* c0,
                                  const void* h0, void* out, void* c, void* h, void* acts,
                                  void* cs, unsigned* flags, void* stream) {
  Plan p;
  if (B < 1 || T < 1 || H < 1 || (dtype != 0 && dtype != 1) || !read_plan(plan_ints, &p) || !xw ||
      !rec || !out || !c || !h || !flags || (acts == nullptr) != (cs == nullptr) ||
      !plan_ok(p, B, H, H, 4, dtype ? 2 : 4))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(B, T, H, p, xw, rec, c0, h0, out, c, h, acts, cs, flags, s);
  return forward<bf16>(B, T, H, p, xw, rec, c0, h0, out, c, h, acts, cs, flags, s);
}

// acts [B, T, 4H] and cs [B, T, H] of the forward, rec_blocks [nb_u, Kp,
// Cp] f32 (rec's rows), c0 [B, H] or null, the gradients dout [B, T, H], dc
// and dh [B, H] (each null for zeros) -> dgates [B, T, 4H], and dc0, dh0
// [B, H] where not null.  dcs: [B, H] f32 scratch; flags as forward.
extern "C" int nbasr_lstm_backward(int dtype, int B, int T, int H, const int* plan_ints,
                                   const void* acts, const void* cs, const float* rec,
                                   const void* c0, const void* dout, const void* dc,
                                   const void* dh, void* dgates, void* dc0, void* dh0,
                                   float* dcs, unsigned* flags, void* stream) {
  Plan p;
  if (B < 1 || T < 1 || H < 1 || (dtype != 0 && dtype != 1) || !read_plan(plan_ints, &p) ||
      !acts || !cs || !rec || !dgates || !dcs || !flags ||
      !plan_ok(p, B, H, 4 * H, 1, dtype ? 2 : 4))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(B, T, H, p, acts, cs, rec, c0, dout, dc, dh, dgates, dc0, dh0, dcs,
                           flags, s);
  return backward<bf16>(B, T, H, p, acts, cs, rec, c0, dout, dc, dh, dgates, dc0, dh0, dcs, flags,
                        s);
}

// The shared memory a block of the current device may opt in to, in bytes,
// and its SM count (-1 on an error): the plan's budget.
extern "C" int nbasr_lstm_shared_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return bytes;
}

extern "C" int nbasr_lstm_sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
