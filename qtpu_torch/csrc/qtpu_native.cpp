// qtpu_torch's native host runtime helpers (C++), exposed via ctypes.
//
// The device path is PyTorch and the CUDA kernels of csrc/; these are the
// HOST-side hot paths around it, where numpy is the bottleneck at 70B-class
// scale:
//   - group-halves int4 packing/unpacking (checkpoint import/export of
//     packed weights; mirrors qtpu_torch.core.packing bit for bit)
//   - per-group asymmetric RTN quantize+pack fused in one pass (streamed
//     HF-import → packed artifact without materialising fp32 copies)
//   - calibration token-block packing (concat ragged samples, split into
//     fixed blocks, the reference's quantization_utils.py:160-164)
//
// Built at first use by qtpu_torch/kernels/_build.py (build_host: g++ -O3
// -march=native -fopenmp -fPIC -shared -Wall, without -fopenmp where the
// compiler has no OpenMP runtime) into the kernels' build directory; loaded
// by qtpu_torch.native (ctypes), with a numpy fallback where no host
// compiler is present. The same source as qtpu/native's.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Pack uint4 values (range [0,15]) in GROUP-HALVES layout along axis 0.
// q: [K, N] uint8; out: [K/2, N] int8. Within each group of g rows, byte j
// holds (low = row j, high = row j + g/2), the high nibble excess-8.
void qtpu_pack_int4(const uint8_t* q, int64_t K, int64_t N, int64_t g,
                    int8_t* out) {
  const int64_t n_groups = K / g;
  const int64_t half = g / 2;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t c = 0; c < n_groups; ++c) {
    for (int64_t j = 0; j < half; ++j) {
      const uint8_t* lo = q + (c * g + j) * N;
      const uint8_t* hi = q + (c * g + half + j) * N;
      int8_t* dst = out + (c * half + j) * N;
      for (int64_t n = 0; n < N; ++n) {
        dst[n] = (int8_t)((lo[n] & 0xF) | (((hi[n] ^ 8) & 0xF) << 4));
      }
    }
  }
}

// Inverse of qtpu_pack_int4. packed: [K/2, N] int8; out: [K, N] uint8.
void qtpu_unpack_int4(const int8_t* packed, int64_t K, int64_t N, int64_t g,
                      uint8_t* out) {
  const int64_t n_groups = K / g;
  const int64_t half = g / 2;
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t c = 0; c < n_groups; ++c) {
    for (int64_t j = 0; j < half; ++j) {
      const uint8_t* src = (const uint8_t*)(packed + (c * half + j) * N);
      uint8_t* lo = out + (c * g + j) * N;
      uint8_t* hi = out + (c * g + half + j) * N;
      for (int64_t n = 0; n < N; ++n) {
        lo[n] = src[n] & 0xF;
        hi[n] = ((src[n] >> 4) & 0xF) ^ 8;  /* excess-8 hi (see packing.py) */
      }
    }
  }
}

// Fused asymmetric per-group RTN quantize + group-halves pack of a [K, N]
// f32 weight (groups tile K). Math parity with qtpu_torch.core.packing
// .quantize_pack / the reference's quantization_utils.py:394-405:
//   scale = max(max-min, 1e-5) / (2^bits - 1)
//   zero  = clamp(round(-min/scale), 0, 2^bits-1)
//   q     = clamp(round(w/scale) + zero, 0, 2^bits-1)
// Outputs: data int8 [K/2, N] (bits=4) or [K, N] biased -128 (bits=8),
// scales f32 [K/g, N], zeros uint8 [K/g, N].
void qtpu_quantize_pack(const float* w, int64_t K, int64_t N, int64_t g,
                        int bits, int8_t* data, float* scales,
                        uint8_t* zeros) {
  const int64_t n_groups = K / g;
  const float max_int = (float)((1 << bits) - 1);
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t c = 0; c < n_groups; ++c) {
    for (int64_t n = 0; n < N; ++n) {
      float mx = -INFINITY, mn = INFINITY;
      for (int64_t j = 0; j < g; ++j) {
        float v = w[(c * g + j) * N + n];
        mx = std::max(mx, v);
        mn = std::min(mn, v);
      }
      float scale = std::max(mx - mn, 1e-5f) / max_int;
      float zero = std::min(std::max(std::nearbyint(-mn / scale), 0.0f), max_int);
      scales[c * N + n] = scale;
      zeros[c * N + n] = (uint8_t)zero;
      if (bits == 4) {
        const int64_t half = g / 2;
        for (int64_t j = 0; j < half; ++j) {
          float vlo = w[(c * g + j) * N + n];
          float vhi = w[(c * g + half + j) * N + n];
          float qlo = std::min(std::max(std::nearbyint(vlo / scale) + zero, 0.0f), max_int);
          float qhi = std::min(std::max(std::nearbyint(vhi / scale) + zero, 0.0f), max_int);
          data[(c * half + j) * N + n] =
              (int8_t)(((uint8_t)qlo & 0xF) | ((((uint8_t)qhi ^ 8) & 0xF) << 4));
        }
      } else {  // bits == 8
        for (int64_t j = 0; j < g; ++j) {
          float v = w[(c * g + j) * N + n];
          float qv = std::min(std::max(std::nearbyint(v / scale) + zero, 0.0f), max_int);
          data[(c * g + j) * N + n] = (int8_t)((int)qv - 128);
        }
      }
    }
  }
}

// Concatenate ragged tokenized samples and split into fixed blocks
// (the reference's quantization_utils.py:160-164). ids: flattened samples;
// lengths[i] = sample i's token count. Returns number of blocks written
// into out ([n_blocks, block] row-major, n_blocks = total // block).
int64_t qtpu_block_pack(const int32_t* ids, const int64_t* lengths,
                        int64_t n_samples, int64_t block, int32_t* out,
                        int64_t out_capacity_blocks) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_samples; ++i) total += lengths[i];
  int64_t n_blocks = std::min(total / block, out_capacity_blocks);
  // samples are already contiguous in `ids`; the packing is one memcpy
  std::memcpy(out, ids, (size_t)(n_blocks * block) * sizeof(int32_t));
  return n_blocks;
}

int qtpu_version() { return 1; }

}  // extern "C"
