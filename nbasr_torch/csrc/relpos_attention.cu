// Transformer-XL relative-position self-attention (the Conformer's) for
// Hopper (sm_90a): one fused kernel forward, two backward.
//
// Replaces no TPU kernel: the JAX package has no attention.  The plain
// formula (nbasr_torch/ops/relpos_attention.py attention_reference)
// materialises [B, H, T, 2T-1] position scores, rel-shifts them into
// [B, H, T, T] and takes a softmax; at a 35 s utterance (T = 875 frames
// after the 4x subsampling, B = 32, H = 8) one such f32 tensor is 1.57 GB
// and 17 layers save several each.  These kernels keep every score on chip.
//
// What they compute, for q, k, v [B, T, H, D] (D = 64), r [2T-1, H, D] (row
// m + T - 1 the projected encoding of the offset m = i - j), the f32 biases
// u, vb [H, D] and the rows' lengths L_b (taken in [1, T]):
//   s_ij = ((q_i + u) . k_j + (q_i + vb) . r_{i-j}) / sqrt(D), j < L_b,
//   out_i = softmax_j(s_ij) v_j for i < L_b, zero for i >= L_b,
// and lse_i, the row's natural log-sum-exp (zero past L_b).  q + u and q + vb
// are rounded to the operands' dtype E before their products; the softmax
// weights P and the backward's dS are rounded to E before theirs.  The
// backward recomputes the scores from the saved lse and gives dq, dk, dv, and
// f32 sums over the batch of dr [H, 2T-1, D], du and dvb [H, D].
//
// Bound on an H100 SXM: operations.  A row's forward is 6 D L^2 flops (the
// content, position and value products) against 4 H D L bytes; a long-bucket
// layer is about 75 GFLOP to 0.1 GB.
//
// Design: a block of 4 warps owns a 64-row tile of one (b, h): query rows
// (forward, dq) or keys (dkv), and walks the other side in 64-row tiles up to
// L_b, skipping tiles past it.  A tile pair (i0, j0) needs the 127 rows of r
// from m = i0 - j0 - 63 on (the "band", staged as 128 rows); the position
// term is the product (q + vb) band^T [64 x 128], kept in shared memory f32,
// from which each score reads column a - b + 63 (a, b the tile's row and
// key): the rel-shift is an indexed read, never a T x T tensor.  The
// backward gathers dS back into the band the same way, dBand[a][c] =
// dS[a][a + 63 - c], whose products give dq's position part (dBand band) and
// dr's band (dBand^T (q + vb)).
//   - forward (a block a query tile, a warp 16 rows): online softmax in
//     registers over the key tiles, P through shared memory into P V;
//     stores out and lse.
//   - bwd_dq (a block a query tile): stores each row's delta = dO . O, then
//     per key tile recomputes P, dP = dO V^T, dS = P (dP - delta) and sums
//     dq's content part dS k and position part dBand band; du and dvb are
//     the two parts' column sums, added by one atomic a column a block.
//   - bwd_dkv (a block a key tile, a warp 16 keys): per query tile recomputes
//     P^T and dS^T, sums dv += P^T dO and dk += dS^T (q + u), and adds dr's
//     band dBand^T (q + vb) into dr by f32 atomics: the band's high half
//     (rows 64-127) is the next query tile's low half, so it is carried in
//     registers and added with it, one 64-row atomic pass a tile pair.
// bf16 runs its products on mma.sync m16n8k16 (bf16 operands from
// ldmatrix, f32 sums); f32 runs them on FMAs with no TF32, in the same
// fragment layout, so the softmax and gather code is shared.
//
// Both entry points run on the caller's stream and return the cudaError_t of
// their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                  // head size
constexpr int kTile = 64;               // query rows or keys a tile
constexpr int kBand = 2 * kTile;        // rows of r a tile pair stages (127 used)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory row pitch (elements) of a tile of `cols` columns of E: padded
// so that ldmatrix's eight rows (bf16) or the FMA path's eight rows (f32) fall
// in distinct banks, and a row stays a multiple of 16 bytes.
template <typename E>
constexpr int pitch(int cols) {
  return cols + (sizeof(E) == 2 ? 8 : 4);
}
constexpr int kBandPitch = kBand + 4;   // the f32 band scores

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The launch's operands; strides in elements.  out, dq, dk, dv are
// contiguous [B, T, H, D]; lse and delta [B, H, T]; dr [H, 2T - 1, D].
template <typename E>
struct Args {
  const E *q, *k, *v, *r, *o, *dout;
  const float *u, *vb;
  const int* lengths;
  E *out, *dq, *dk, *dv;
  float *lse, *delta, *dr, *du, *dvb;
  long long sq[3], sk[3], sv[3], sr[2], so[3], sdo[3];
  int B, T, H;
  float scale;   // 1 / sqrt(D)
};

template <typename E>
__device__ __forceinline__ int row_length(const Args<E>& a, int b) {
  return min(max(a.lengths[b], 1), a.T);
}

// ---------------------------------------------------------------------------
// staging: 16-byte vectors, rows outside [lo, hi) as zeros
// ---------------------------------------------------------------------------

template <typename E>
__device__ __forceinline__ void load_rows(E* dst, int ld, const E* src, long long stride, int row0,
                                          int rows, int lo, int hi) {
  constexpr int V = 16 / sizeof(E);
  constexpr int C = kD / V;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int row = i / C, c = (i % C) * V, g = row0 + row;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g >= lo && g < hi) val = *reinterpret_cast<const uint4*>(src + g * stride + c);
    *reinterpret_cast<uint4*>(dst + row * ld + c) = val;
  }
}

// q + u and q + vb of rows [row0, row0 + kTile), rounded to E; rows at or past
// hi as zeros.
template <typename E>
__device__ __forceinline__ void load_query(E* qu, E* qv, int ld, const E* src, long long stride,
                                           int row0, int hi, const float* u, const float* vb) {
  constexpr int V = 16 / sizeof(E);
  constexpr int C = kD / V;
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int row = i / C, c = (i % C) * V, g = row0 + row;
    uint4 x = make_uint4(0u, 0u, 0u, 0u), yu = x, yv = x;
    if (g < hi) {
      x = *reinterpret_cast<const uint4*>(src + g * stride + c);
      const E* xe = reinterpret_cast<const E*>(&x);
      E* ue = reinterpret_cast<E*>(&yu);
      E* ve = reinterpret_cast<E*>(&yv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(xe[j]);
        ue[j] = from_f<E>(f + u[c + j]);
        ve[j] = from_f<E>(f + vb[c + j]);
      }
    }
    *reinterpret_cast<uint4*>(qu + row * ld + c) = yu;
    *reinterpret_cast<uint4*>(qv + row * ld + c) = yv;
  }
}

// ---------------------------------------------------------------------------
// warp products into m16n8 accumulator fragments: lane (g = lane / 4,
// t = lane % 4) holds rows g (elements 0, 1) and g + 8 (2, 3), columns
// 8 n + 2 t and + 1 of n-tile n
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* A, int lda, int k0) {
  const int lane = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(A + (lane & 15) * lda + k0 + (lane >> 4) * 8)));
}

// acc[n] += A[16][K] B[8 n .. 8 n + 8)[K]^T; A and B row-major in shared memory.
template <int NT>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const bf16* A, int lda, const bf16* B,
                                        int ldb, int K) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[4];
    load_a(a, A, lda, k0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned b[2];
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(b[0]), "=r"(b[1])
                   : "r"(smem_addr(B + (8 * n + (lane & 7)) * ldb + k0 + ((lane >> 3) & 1) * 8)));
      mma(acc[n], a, b);
    }
  }
}

// acc[n] += A[16][K] B[K][8 n .. 8 n + 8); B row-major [K][N] (ldmatrix.trans).
template <int NT>
__device__ __forceinline__ void gemm_nn(float (&acc)[NT][4], const bf16* A, int lda, const bf16* B,
                                        int ldb, int K) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[4];
    load_a(a, A, lda, k0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned b[2];
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(b[0]), "=r"(b[1])
                   : "r"(smem_addr(B + (k0 + (lane & 15)) * ldb + 8 * n)));
      mma(acc[n], a, b);
    }
  }
}

template <int NT>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const float* A, int lda,
                                        const float* B, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = B[(8 * n + 2 * t) * ldb + k], b1 = B[(8 * n + 2 * t + 1) * ldb + k];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void gemm_nn(float (&acc)[NT][4], const float* A, int lda,
                                        const float* B, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = B[k * ldb + 8 * n + 2 * t], b1 = B[k * ldb + 8 * n + 2 * t + 1];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// dst[16][8 NT] (row pitch ld) = acc, rounded to T.
template <typename T, int NT>
__device__ __forceinline__ void store_frag(T* dst, int ld, const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[(g + 8 * (e >> 1)) * ld + 8 * n + 2 * t + (e & 1)] = from_f<T>(acc[n][e]);
}

// The position term of a warp's 16 query rows: (q + vb) band^T [16 x 128] f32
// into bw (pitch kBandPitch), in two halves of 64 columns.
template <typename E>
__device__ __forceinline__ void band_scores(float* bw, const E* qv_w, int ld, const E* rs) {
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    float c[8][4];
    zero(c);
    gemm_nt<8>(c, qv_w, ld, rs + half * kTile * ld, ld, kD);
    store_frag(bw + half * kTile, kBandPitch, c);
  }
}

// s[16 rows of the warp][64 keys] of a tile pair, in log2 units (times
// log2(e) / sqrt(D)), -inf at keys >= L.  r0: the warp's first row in the
// query tile.  Reads the band scores of the warp's rows from bw.
template <typename E>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const E* qu_w, int ld, const E* ks,
                                            const float* bw, int r0, int j0, int L, float scale2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  zero(s);
  gemm_nt<8>(s, qu_w, ld, ks, ld, kD);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), col = 8 * n + 2 * t + (e & 1);
      const float pos = bw[row * kBandPitch + r0 + row - col + kTile - 1];
      s[n][e] = j0 + col < L ? (s[n][e] + pos) * scale2 : -INFINITY;
    }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename E>
struct FwdSmem {
  static constexpr int ld = pitch<E>(kD), ldp = pitch<E>(kTile);
  static constexpr int tiles = (4 * kTile + kBand) * ld * sizeof(E);   // qu, qv, k, v, band of r
  static constexpr int band = kWarps * 16 * kBandPitch * 4;
  static constexpr int p = kWarps * 16 * ldp * sizeof(E);
  static constexpr int bytes = tiles + band + p;
};

template <typename E>
__global__ void __launch_bounds__(kThreads, 2) nbasr_relpos_attn_fwd(const Args<E> a) {
  using S = FwdSmem<E>;
  constexpr int ld = S::ld, ldp = S::ldp;
  extern __shared__ __align__(16) unsigned char smem[];
  E* qu = reinterpret_cast<E*>(smem);
  E* qv = qu + kTile * ld;
  E* ks = qv + kTile * ld;
  E* vs = ks + kTile * ld;
  E* rs = vs + kTile * ld;
  float* band = reinterpret_cast<float*>(smem + S::tiles);
  E* ps = reinterpret_cast<E*>(smem + S::tiles + S::band);

  const int T = a.T, H = a.H, bh = blockIdx.y, b = bh / H, h = bh % H, i0 = blockIdx.x * kTile;
  const int L = row_length(a, b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const float scale2 = a.scale * kLog2e;
  float* bw = band + warp * 16 * kBandPitch;
  E* pw = ps + warp * 16 * ldp;

  load_query(qu, qv, ld, a.q + b * a.sq[0] + h * a.sq[2], a.sq[1], i0, L, a.u + h * kD,
             a.vb + h * kD);
  float o[8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int kend = i0 < L ? L : 0;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    load_rows(ks, ld, a.k + b * a.sk[0] + h * a.sk[2], a.sk[1], j0, kTile, 0, L);
    load_rows(vs, ld, a.v + b * a.sv[0] + h * a.sv[2], a.sv[1], j0, kTile, 0, L);
    load_rows(rs, ld, a.r + h * a.sr[1], a.sr[0], i0 - j0 - (kTile - 1) + T - 1, kBand, 0,
              2 * T - 1);
    __syncthreads();
    band_scores(bw, qv + r0 * ld, ld, rs);
    float s[8][4];
    tile_scores(s, qu + r0 * ld, ld, ks, bw, r0, j0, L, scale2);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    // key j0 < L is valid, so mx is finite; exp2(-inf) = 0 on the first tile
    const float alpha[2] = {exp2_approx(m[0] - mx[0]), exp2_approx(m[1] - mx[1])};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - mx[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = mx[i];
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    store_frag(pw, ldp, s);
    __syncwarp();
    gemm_nn<8>(o, pw, ldp, vs, ld, kTile);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + r0 + g + 8 * i;
    if (row >= T) continue;
    const bool ok = row < L;
    const float inv = ok ? 1.f / l[i] : 0.f;
    E* dst = a.out + ((static_cast<long long>(b) * T + row) * H + h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      dst[8 * n + 2 * t] = from_f<E>(o[n][2 * i] * inv);
      dst[8 * n + 2 * t + 1] = from_f<E>(o[n][2 * i + 1] * inv);
    }
    if (t == 0) a.lse[static_cast<long long>(bh) * T + row] = ok ? (m[i] + log2f(l[i])) * kLn2 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward: dq (with du, dvb and each row's delta)
// ---------------------------------------------------------------------------

template <typename E>
struct DqSmem {
  static constexpr int ld = pitch<E>(kD), ldp = pitch<E>(kTile), ldd = pitch<E>(kBand);
  static constexpr int tiles = (5 * kTile + kBand) * ld * sizeof(E);   // qu, qv, dO, k, v, band
  // a warp's band scores, then (once read) its dBand [16][ldd] of E
  static constexpr int band_warp = 16 * kBandPitch * 4;
  static_assert(16 * ldd * sizeof(E) <= band_warp, "dBand must fit the band scores");
  static constexpr int band = kWarps * band_warp;
  static constexpr int ds = kWarps * 16 * ldp * sizeof(E);
  static constexpr int rows = 2 * kTile * 4;                              // lse, delta
  static constexpr int bytes = tiles + band + ds + rows;
};

template <typename E>
__global__ void __launch_bounds__(kThreads, 2) nbasr_relpos_attn_bwd_dq(const Args<E> a) {
  using S = DqSmem<E>;
  constexpr int ld = S::ld, ldp = S::ldp, ldd = S::ldd;
  extern __shared__ __align__(16) unsigned char smem[];
  E* qu = reinterpret_cast<E*>(smem);
  E* qv = qu + kTile * ld;
  E* dos = qv + kTile * ld;
  E* ks = dos + kTile * ld;
  E* vs = ks + kTile * ld;
  E* rs = vs + kTile * ld;
  float* band = reinterpret_cast<float*>(smem + S::tiles);
  E* dsm = reinterpret_cast<E*>(smem + S::tiles + S::band);
  float* lse_s = reinterpret_cast<float*>(smem + S::tiles + S::band + S::ds);
  float* delta_s = lse_s + kTile;

  const int T = a.T, H = a.H, bh = blockIdx.y, b = bh / H, h = bh % H, i0 = blockIdx.x * kTile;
  const int L = row_length(a, b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  const float scale2 = a.scale * kLog2e;
  float* bw = band + warp * 16 * kBandPitch;
  E* dbw = reinterpret_cast<E*>(bw);
  E* dsw = dsm + warp * 16 * ldp;

  load_query(qu, qv, ld, a.q + b * a.sq[0] + h * a.sq[2], a.sq[1], i0, L, a.u + h * kD,
             a.vb + h * kD);
  load_rows(dos, ld, a.dout + b * a.sdo[0] + h * a.sdo[2], a.sdo[1], i0, kTile, 0, L);
  {
    // delta = dO . O of each row, two threads a row
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1, gr = i0 + row;
    float sum = 0.f;
    if (gr < L) {
      const E* po = a.o + b * a.so[0] + gr * a.so[1] + h * a.so[2] + half * (kD / 2);
      const E* pd = a.dout + b * a.sdo[0] + gr * a.sdo[1] + h * a.sdo[2] + half * (kD / 2);
      for (int d = 0; d < kD / 2; ++d) sum += to_f(pd[d]) * to_f(po[d]);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      delta_s[row] = sum;
      lse_s[row] = gr < L ? a.lse[static_cast<long long>(bh) * T + gr] : 0.f;
      if (gr < T) a.delta[static_cast<long long>(bh) * T + gr] = sum;
    }
  }
  float dqc[8][4], dqp[8][4];
  zero(dqc);
  zero(dqp);
  bool rok[2];
  float rlse[2], rdelta[2];
  const int kend = i0 < L ? L : 0;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();
    load_rows(ks, ld, a.k + b * a.sk[0] + h * a.sk[2], a.sk[1], j0, kTile, 0, L);
    load_rows(vs, ld, a.v + b * a.sv[0] + h * a.sv[2], a.sv[1], j0, kTile, 0, L);
    load_rows(rs, ld, a.r + h * a.sr[1], a.sr[0], i0 - j0 - (kTile - 1) + T - 1, kBand, 0,
              2 * T - 1);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      rok[i] = i0 + row < L;
      rlse[i] = lse_s[row] * kLog2e;
      rdelta[i] = delta_s[row];
    }
    band_scores(bw, qv + r0 * ld, ld, rs);
    float s[8][4];
    tile_scores(s, qu + r0 * ld, ld, ks, bw, r0, j0, L, scale2);
    float dp[8][4];
    zero(dp);
    gemm_nt<8>(dp, dos + r0 * ld, ld, vs, ld, kD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = rok[i] ? exp2_approx(s[n][e] - rlse[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - rdelta[i]);
      }
    store_frag(dsw, ldp, s);
    __syncwarp();   // dS complete; every lane is past its reads of bw
    gemm_nn<8>(dqc, dsw, ldp, ks, ld, kTile);
    for (int idx = lane; idx < 16 * kBand; idx += 32) {
      const int row = idx / kBand, c = idx % kBand, key = r0 + row + kTile - 1 - c;
      dbw[row * ldd + c] = key >= 0 && key < kTile ? dsw[row * ldp + key] : from_f<E>(0.f);
    }
    __syncwarp();
    gemm_nn<8>(dqp, dbw, ldd, rs, ld, kBand);
  }
  // dq, then du and dvb: the two parts' column sums over the block's rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + r0 + g + 8 * i;
    if (row >= T) continue;
    E* dst = a.dq + ((static_cast<long long>(b) * T + row) * H + h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        dst[8 * n + 2 * t + j] = from_f<E>((dqc[n][2 * i + j] + dqp[n][2 * i + j]) * a.scale);
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(ks);   // [2][kWarps][kD]
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float c = dqc[n][j] + dqc[n][2 + j], p = dqp[n][j] + dqp[n][2 + j];
#pragma unroll
      for (int x = 4; x < 32; x <<= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, x);
        p += __shfl_xor_sync(0xffffffffu, p, x);
      }
      if (g == 0) {
        red[warp * kD + 8 * n + 2 * t + j] = c;
        red[(kWarps + warp) * kD + 8 * n + 2 * t + j] = p;
      }
    }
  __syncthreads();
  if (kend > 0) {
    const int part = threadIdx.x / kD, col = threadIdx.x % kD;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[(part * kWarps + w) * kD + col];
    atomicAdd((part ? a.dvb : a.du) + h * kD + col, sum * a.scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv and dr
// ---------------------------------------------------------------------------

template <typename E>
struct DkvSmem {
  static constexpr int ld = pitch<E>(kD), ldp = pitch<E>(kTile);
  static constexpr int tiles = (5 * kTile + kBand) * ld * sizeof(E);   // k, v, qu, qv, dO, band
  // the query tile's band scores [64][kBandPitch] f32, then dBand^T [128][ldp] of E
  static constexpr int band_scores = kTile * kBandPitch * 4;
  static constexpr int dband = kBand * ldp * sizeof(E);
  static constexpr int band = band_scores > dband ? band_scores : dband;
  static constexpr int ds = kTile * ldp * sizeof(E);                      // P^T, then dS^T
  static constexpr int rows = 2 * kTile * 4;
  static constexpr int bytes = tiles + band + ds + rows;
};

// dr[m0 + row] += scale * acc (16 rows of 64), rows outside [0, M) left out.
__device__ __forceinline__ void add_band_rows(float* dr, int m0, const float (&acc)[8][4],
                                              float scale, int M) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + g + 8 * i;
    if (m < 0 || m >= M) continue;
    float* row = dr + static_cast<long long>(m) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#if __CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 8)
      atomicAdd(reinterpret_cast<float2*>(row + 8 * n),
                make_float2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale));
#else
      atomicAdd(row + 8 * n, acc[n][2 * i] * scale);
      atomicAdd(row + 8 * n + 1, acc[n][2 * i + 1] * scale);
#endif
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 2) nbasr_relpos_attn_bwd_dkv(const Args<E> a) {
  using S = DkvSmem<E>;
  constexpr int ld = S::ld, ldp = S::ldp;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ks = reinterpret_cast<E*>(smem);
  E* vs = ks + kTile * ld;
  E* qu = vs + kTile * ld;
  E* qv = qu + kTile * ld;
  E* dos = qv + kTile * ld;
  E* rs = dos + kTile * ld;
  float* band = reinterpret_cast<float*>(smem + S::tiles);
  E* dbt = reinterpret_cast<E*>(band);
  E* dst = reinterpret_cast<E*>(smem + S::tiles + S::band);
  float* lse_s = reinterpret_cast<float*>(smem + S::tiles + S::band + S::ds);
  float* delta_s = lse_s + kTile;

  const int T = a.T, H = a.H, bh = blockIdx.y, b = bh / H, h = bh % H, j0 = blockIdx.x * kTile;
  const int L = row_length(a, b), M = 2 * T - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;   // the warp's keys in the tile
  const float scale2 = a.scale * kLog2e;
  float* dr = a.dr + static_cast<long long>(h) * M * kD;
  E* dsw = dst + r0 * ldp;

  load_rows(ks, ld, a.k + b * a.sk[0] + h * a.sk[2], a.sk[1], j0, kTile, 0, L);
  load_rows(vs, ld, a.v + b * a.sv[0] + h * a.sv[2], a.sv[1], j0, kTile, 0, L);
  float dk[8][4], dv[8][4], carry[8][4];
  zero(dk);
  zero(dv);
  zero(carry);
  bool kok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kok[i] = j0 + r0 + g + 8 * i < L;
  int base = 0;
  const int qend = j0 < L ? L : 0;
  for (int i0 = 0; i0 < qend; i0 += kTile) {
    __syncthreads();
    base = i0 - j0 - (kTile - 1) + T - 1;
    load_query(qu, qv, ld, a.q + b * a.sq[0] + h * a.sq[2], a.sq[1], i0, L, a.u + h * kD,
               a.vb + h * kD);
    load_rows(dos, ld, a.dout + b * a.sdo[0] + h * a.sdo[2], a.sdo[1], i0, kTile, 0, L);
    load_rows(rs, ld, a.r + h * a.sr[1], a.sr[0], base, kBand, 0, M);
    if (threadIdx.x < kTile) {
      const int gr = i0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * T + gr;
      lse_s[threadIdx.x] = gr < L ? a.lse[at] * kLog2e : 0.f;
      delta_s[threadIdx.x] = gr < L ? a.delta[at] : 0.f;
    }
    __syncthreads();
    band_scores(band + r0 * kBandPitch, qv + r0 * ld, ld, rs);   // the warp's 16 query rows
    __syncthreads();
    // S^T: the warp's 16 keys by the tile's 64 queries
    float st[8][4];
    zero(st);
    gemm_nt<8>(st, ks + r0 * ld, ld, qu, ld, kD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + 8 * (e >> 1), qa = 8 * n + 2 * t + (e & 1);
        const float pos = band[qa * kBandPitch + qa - key + kTile - 1];
        const float s = (st[n][e] + pos) * scale2;
        st[n][e] = kok[e >> 1] && i0 + qa < L ? exp2_approx(s - lse_s[qa]) : 0.f;
      }
    store_frag(dsw, ldp, st);
    __syncwarp();
    gemm_nn<8>(dv, dsw, ldp, dos, ld, kTile);
    float dpt[8][4];
    zero(dpt);
    gemm_nt<8>(dpt, vs + r0 * ld, ld, dos, ld, kD);
    __syncwarp();   // every lane is past its reads of P^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] *= dpt[n][e] - delta_s[8 * n + 2 * t + (e & 1)];
    store_frag(dsw, ldp, st);
    __syncthreads();   // dS^T whole; the band scores read
    gemm_nn<8>(dk, dsw, ldp, qu, ld, kTile);
    // dBand^T[c][qa] = dS^T[qa + 63 - c][qa]
    for (int idx = threadIdx.x; idx < kBand * kTile; idx += kThreads) {
      const int c = idx / kTile, qa = idx % kTile, key = qa + kTile - 1 - c;
      dbt[c * ldp + qa] = key >= 0 && key < kTile ? dst[key * ldp + qa] : from_f<E>(0.f);
    }
    __syncthreads();
    float lo[8][4];
    zero(lo);
    gemm_nn<8>(lo, dbt + r0 * ldp, ldp, qv, ld, kTile);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[n][e] += carry[n][e];
    add_band_rows(dr, base + r0, lo, a.scale, M);
    zero(carry);
    gemm_nn<8>(carry, dbt + (kTile + r0) * ldp, ldp, qv, ld, kTile);
  }
  if (qend > 0) add_band_rows(dr, base + kTile + r0, carry, a.scale, M);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = j0 + r0 + g + 8 * i;
    if (key >= T) continue;
    const long long at = ((static_cast<long long>(b) * T + key) * H + h) * kD;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        a.dk[at + 8 * n + 2 * t + j] = from_f<E>(dk[n][2 * i + j] * a.scale);
        a.dv[at + 8 * n + 2 * t + j] = from_f<E>(dv[n][2 * i + j]);
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, const void* args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<void*>(args)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid, dim3(kThreads), params,
                          static_cast<size_t>(smem), stream);
}

template <typename E>
void fill(Args<E>* a, int B, int T, int H, const void* q, const void* k, const void* v,
          const void* r, const float* u, const float* vb, const int* lengths,
          const long long* strides) {
  a->q = static_cast<const E*>(q);
  a->k = static_cast<const E*>(k);
  a->v = static_cast<const E*>(v);
  a->r = static_cast<const E*>(r);
  a->u = u;
  a->vb = vb;
  a->lengths = lengths;
  for (int i = 0; i < 3; ++i) {
    a->sq[i] = strides[i];
    a->sk[i] = strides[3 + i];
    a->sv[i] = strides[6 + i];
  }
  a->sr[0] = strides[9];
  a->sr[1] = strides[10];
  a->B = B;
  a->T = T;
  a->H = H;
  a->scale = 0.125f;   // 1 / sqrt(kD)
}

dim3 grid_of(int B, int T, int H) { return dim3((T + kTile - 1) / kTile, B * H); }

template <typename E>
cudaError_t forward(int B, int T, int H, const void* q, const void* k, const void* v,
                    const void* r, const float* u, const float* vb, const int* lengths,
                    const long long* strides, void* out, float* lse, cudaStream_t stream) {
  Args<E> a = {};
  fill(&a, B, T, H, q, k, v, r, u, vb, lengths, strides);
  a.out = static_cast<E*>(out);
  a.lse = lse;
  return launch(nbasr_relpos_attn_fwd<E>, FwdSmem<E>::bytes, grid_of(B, T, H), &a, stream);
}

template <typename E>
cudaError_t backward(int B, int T, int H, const void* q, const void* k, const void* v,
                     const void* r, const float* u, const float* vb, const int* lengths,
                     const void* o, const float* lse, const void* dout, const long long* strides,
                     void* dq, void* dk, void* dv, float* dr, float* du, float* dvb, float* delta,
                     cudaStream_t stream) {
  Args<E> a = {};
  fill(&a, B, T, H, q, k, v, r, u, vb, lengths, strides);
  a.o = static_cast<const E*>(o);
  a.dout = static_cast<const E*>(dout);
  for (int i = 0; i < 3; ++i) {
    a.so[i] = strides[11 + i];
    a.sdo[i] = strides[14 + i];
  }
  a.lse = const_cast<float*>(lse);
  a.dq = static_cast<E*>(dq);
  a.dk = static_cast<E*>(dk);
  a.dv = static_cast<E*>(dv);
  a.dr = dr;
  a.du = du;
  a.dvb = dvb;
  a.delta = delta;
  const dim3 grid = grid_of(B, T, H);
  cudaError_t err = launch(nbasr_relpos_attn_bwd_dq<E>, DqSmem<E>::bytes, grid, &a, stream);
  if (err != cudaSuccess) return err;
  return launch(nbasr_relpos_attn_bwd_dkv<E>, DkvSmem<E>::bytes, grid, &a, stream);
}

bool shapes_ok(int dtype, int B, int T, int H, int D) {
  return (dtype == 0 || dtype == 1) && B >= 1 && T >= 1 && H >= 1 && D == kD &&
         static_cast<long long>(B) * H <= 65535;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  q, k, v [B, T, H, D] and r [2T - 1, H, D]
// of that dtype with a unit last stride, 16-byte aligned rows; strides: q's,
// k's and v's first three, r's first two (elements).  u, vb [H, D] f32 and
// lengths [B] int32, contiguous.  -> out [B, T, H, D] contiguous, lse [B, H, T]
// f32.  D must be 64.
extern "C" int nbasr_relpos_attn_forward(int dtype, int B, int T, int H, int D, const void* q,
                                         const void* k, const void* v, const void* r,
                                         const float* u, const float* vb, const int* lengths,
                                         const long long* strides, void* out, float* lse,
                                         void* stream) {
  if (!shapes_ok(dtype, B, T, H, D) || !q || !k || !v || !r || !u || !vb || !lengths ||
      !strides || !out || !lse)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(B, T, H, q, k, v, r, u, vb, lengths, strides, out, lse, s);
  return forward<bf16>(B, T, H, q, k, v, r, u, vb, lengths, strides, out, lse, s);
}

// The forward's operands, its out and lse, and dout [B, T, H, D]; strides as
// the forward's, then out's and dout's first three.  -> dq, dk, dv [B, T, H,
// D] contiguous; dr [H, 2T - 1, D], du and dvb [H, D] f32, added into (zeroed
// by the caller); delta [B, H, T] f32 scratch.
extern "C" int nbasr_relpos_attn_backward(int dtype, int B, int T, int H, int D, const void* q,
                                          const void* k, const void* v, const void* r,
                                          const float* u, const float* vb, const int* lengths,
                                          const void* o, const float* lse, const void* dout,
                                          const long long* strides, void* dq, void* dk, void* dv,
                                          float* dr, float* du, float* dvb, float* delta,
                                          void* stream) {
  if (!shapes_ok(dtype, B, T, H, D) || !q || !k || !v || !r || !u || !vb || !lengths || !o ||
      !lse || !dout || !strides || !dq || !dk || !dv || !dr || !du || !dvb || !delta)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(B, T, H, q, k, v, r, u, vb, lengths, o, lse, dout, strides, dq, dk, dv,
                           dr, du, dvb, delta, s);
  return backward<bf16>(B, T, H, q, k, v, r, u, vb, lengths, o, lse, dout, strides, dq, dk, dv,
                        dr, du, dvb, delta, s);
}

extern "C" const char* nbasr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
