// nbasr_native: host-side native runtime of nbasr_torch.
//
// Native equivalents of the components that are C++/CUDA in the reference's
// dependency chain:
//   - wav parsing (RIFF + NIST SPHERE)  [data-loader hot path]
//   - batched Levenshtein distance       [torch-edit-distance CUDA kernel]
//   - CTC prefix beam search             [ctcdecode C++ decoder]
//
// The card runs the port's kernels in nbasr_torch/csrc/*.cu; these host
// implementations serve the data loader, offline/CPU decoding, and act as
// independent oracles for the on-device decoders.  Exposed as a plain C ABI
// for ctypes (nbasr_torch/native.py), built with g++ into build/nbasr_torch/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV parsing: RIFF PCM16 and NIST SPHERE. Two-call protocol:
//   parse_wav_info(data, len, &n_samples, &rate) -> 0 ok / negative error
//   parse_wav_fill(data, len, out)               -> 0 ok
// ---------------------------------------------------------------------------

static int32_t read_le32(const uint8_t* p) {
  return (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24));
}
static int32_t read_le16(const uint8_t* p) { return (int32_t)(p[0] | (p[1] << 8)); }

struct WavInfo {
  int64_t n_samples = 0;
  int32_t sample_rate = 16000;
  int32_t channels = 1;
  int32_t bits = 16;
  bool big_endian = false;
  const uint8_t* pcm = nullptr;
};

static int parse_riff(const uint8_t* data, int64_t len, WavInfo* info) {
  if (len < 44 || memcmp(data, "RIFF", 4) || memcmp(data + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int64_t data_size = 0;
  while (pos + 8 <= len) {
    const uint8_t* chunk = data + pos;
    int64_t size = (uint32_t)read_le32(chunk + 4);
    if (!memcmp(chunk, "fmt ", 4) && size >= 16) {
      info->channels = read_le16(chunk + 10);
      info->sample_rate = read_le32(chunk + 12);
      info->bits = read_le16(chunk + 22);
    } else if (!memcmp(chunk, "data", 4)) {
      info->pcm = chunk + 8;
      data_size = std::min<int64_t>(size, len - pos - 8);
    }
    pos += 8 + size + (size & 1);
  }
  if (!info->pcm || info->bits != 16 || info->channels < 1) return -2;
  info->n_samples = data_size / 2 / info->channels;
  return 0;
}

static int parse_sphere(const uint8_t* data, int64_t len, WavInfo* info) {
  if (len < 1024 || memcmp(data, "NIST_1A", 7)) return -1;
  // header size on the second line (ASCII)
  std::string head((const char*)data, std::min<int64_t>(len, 1024));
  int64_t header_bytes = 1024;
  size_t nl = head.find('\n');
  if (nl != std::string::npos) {
    size_t nl2 = head.find('\n', nl + 1);
    if (nl2 != std::string::npos)
      header_bytes = strtol(head.substr(nl + 1, nl2 - nl - 1).c_str(), nullptr, 10);
  }
  std::string full((const char*)data, std::min<int64_t>(len, header_bytes));
  auto field = [&](const char* key) -> std::string {
    size_t p = full.find(key);
    if (p == std::string::npos) return "";
    size_t eol = full.find('\n', p);
    std::string line = full.substr(p, eol - p);
    size_t sp = line.rfind(' ');
    return sp == std::string::npos ? "" : line.substr(sp + 1);
  };
  std::string rate = field("sample_rate");
  if (!rate.empty()) info->sample_rate = atoi(rate.c_str());
  std::string nbytes = field("sample_n_bytes");
  if (!nbytes.empty() && atoi(nbytes.c_str()) != 2) return -3;
  std::string fmt = field("sample_byte_format");
  info->big_endian = (fmt == "10");
  std::string ch = field("channel_count");
  if (!ch.empty()) info->channels = atoi(ch.c_str());
  if (info->channels < 1) info->channels = 1;
  info->pcm = data + header_bytes;
  info->n_samples = (len - header_bytes) / 2 / info->channels;
  return 0;
}

static int parse_any(const uint8_t* data, int64_t len, WavInfo* info) {
  if (len >= 7 && !memcmp(data, "NIST_1A", 7)) return parse_sphere(data, len, info);
  return parse_riff(data, len, info);
}

int parse_wav_info(const uint8_t* data, int64_t len, int64_t* n_samples,
                   int32_t* sample_rate) {
  WavInfo info;
  int rc = parse_any(data, len, &info);
  if (rc) return rc;
  *n_samples = info.n_samples;
  *sample_rate = info.sample_rate;
  return 0;
}

int parse_wav_fill(const uint8_t* data, int64_t len, float* out) {
  WavInfo info;
  int rc = parse_any(data, len, &info);
  if (rc) return rc;
  const uint8_t* p = info.pcm;
  const float scale = 1.0f / 32768.0f;
  for (int64_t i = 0; i < info.n_samples; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < info.channels; ++c) {
      const uint8_t* s = p + (i * info.channels + c) * 2;
      int16_t v = info.big_endian ? (int16_t)((s[0] << 8) | s[1])
                                  : (int16_t)(s[0] | (s[1] << 8));
      acc += (float)v;
    }
    out[i] = acc * scale / (float)info.channels;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched Levenshtein distance over 0-padded int32 id sequences.
// hyp [B, M], ref [B, N]; lengths given explicitly; out [B] float32.
// ---------------------------------------------------------------------------

void levenshtein_batch(const int32_t* hyp, const int32_t* hyp_len,
                       const int32_t* ref, const int32_t* ref_len,
                       int32_t B, int32_t M, int32_t N, float* out) {
  std::vector<int32_t> prev(N + 1), cur(N + 1);
  for (int32_t b = 0; b < B; ++b) {
    const int32_t m = hyp_len[b], n = ref_len[b];
    const int32_t* h = hyp + (int64_t)b * M;
    const int32_t* r = ref + (int64_t)b * N;
    for (int32_t j = 0; j <= n; ++j) prev[j] = j;
    for (int32_t i = 1; i <= m; ++i) {
      cur[0] = i;
      for (int32_t j = 1; j <= n; ++j) {
        int32_t sub = prev[j - 1] + (h[i - 1] != r[j - 1]);
        cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
      }
      std::swap(prev, cur);
    }
    out[b] = (float)prev[n];
  }
}

// ---------------------------------------------------------------------------
// CTC prefix beam search (merged prefixes), host decoder.
// log_probs [T, V] row-major; blank index configurable; returns top prefix.
// Reference-equivalent of ctcdecode.CTCBeamDecoder (setup.py:49).
// ---------------------------------------------------------------------------

static inline float log_add(float a, float b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  float mx = std::max(a, b);
  return mx + std::log(std::exp(a - mx) + std::exp(b - mx));
}

void ctc_beam_search(const float* log_probs, int32_t T, int32_t V,
                     int32_t beam_width, int32_t blank, int32_t max_len,
                     int32_t* out_labels, int32_t* out_len) {
  struct Score { float pb, pnb; };
  using Prefix = std::vector<int32_t>;
  std::map<Prefix, Score> beams;
  beams[{}] = {0.0f, -INFINITY};

  for (int32_t t = 0; t < T; ++t) {
    const float* lp = log_probs + (int64_t)t * V;
    std::map<Prefix, Score> next;
    auto add = [&](const Prefix& p, float pb, float pnb) {
      auto it = next.find(p);
      if (it == next.end()) {
        next[p] = {pb, pnb};
      } else {
        it->second.pb = log_add(it->second.pb, pb);
        it->second.pnb = log_add(it->second.pnb, pnb);
      }
    };
    for (const auto& [prefix, sc] : beams) {
      float total = log_add(sc.pb, sc.pnb);
      int32_t last = prefix.empty() ? -1 : prefix.back();
      // stay: blank emission
      add(prefix, total + lp[blank], -INFINITY);
      // stay: repeat last char (collapses)
      if (last >= 0) add(prefix, -INFINITY, sc.pnb + lp[last]);
      // extend
      for (int32_t c = 0; c < V; ++c) {
        if (c == blank) continue;
        float p = lp[c] + (c == last ? sc.pb : total);
        if ((int32_t)prefix.size() < max_len) {
          Prefix ext = prefix;
          ext.push_back(c);
          add(ext, -INFINITY, p);
        }
      }
    }
    // prune to beam_width by total probability
    std::vector<std::pair<float, Prefix>> scored;
    scored.reserve(next.size());
    for (const auto& [prefix, sc] : next)
      scored.emplace_back(log_add(sc.pb, sc.pnb), prefix);
    std::partial_sort(
        scored.begin(),
        scored.begin() + std::min<size_t>(beam_width, scored.size()),
        scored.end(),
        [](const auto& a, const auto& b) { return a.first > b.first; });
    std::map<Prefix, Score> pruned;
    for (size_t i = 0; i < std::min<size_t>(beam_width, scored.size()); ++i)
      pruned[scored[i].second] = next[scored[i].second];
    beams = std::move(pruned);
  }

  const Prefix* best = nullptr;
  float best_score = -INFINITY;
  for (const auto& [prefix, sc] : beams) {
    float total = log_add(sc.pb, sc.pnb);
    if (total > best_score) {
      best_score = total;
      best = &prefix;
    }
  }
  int32_t n = best ? std::min<int32_t>((int32_t)best->size(), max_len) : 0;
  for (int32_t i = 0; i < n; ++i) out_labels[i] = (*best)[i];
  *out_len = n;
}

}  // extern "C"
