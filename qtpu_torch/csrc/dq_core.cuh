// Dequant-matmul core shared by K1 (dequant_matmul.cu), K4 (fused_mlp.cu),
// K7 (codebook_matmul.cu), K9/K10 (moe_matmul.cu) and K13
// (layer_boundary.cu).
//
// y[m, n] = sum_k x[m, k] * (q[k, n] - z[g(k), n]) * s[g(k), n]
// and, in the codebook mode (MODE 3, W4 only),
// y[m, n] = sum_k x[m, k] * cb[q[k, n]] * s[g(k), n]
//
// Layout (qtpu.core.packing): the weight is [K, N] packed along K into
// [K / PK, N] int8 bytes, PK = 8 / BITS. Within each group of g K-rows the
// packed rows are group fractions: packed row j of group c holds field p at
// K index c*g + p*(g/PK) + j (W4: low nibble p=0, excess-8 high nibble p=1;
// W2: bit pairs p=0..3; W8: one byte biased by -128). Scales are bf16
// [K/g, N], zeros uint8 [K/g, N] or absent (symmetric: z = 2^(BITS-1)).
//
// Design. A block owns BN = 4*CQ output columns and TM rows; each thread
// owns 4 adjacent columns (one 32-bit load of packed bytes per packed row)
// and all TM rows, so every weight byte is read from device memory once per
// row tile and dequantized in registers ((q - z) * s in f32, the per-group
// scale and zero applied in f32 as the TPU kernel does). The 256/CQ thread
// "lanes" of a block split K, each walking a contiguous run of packed rows
// with kUnroll loads in flight; activations are staged in shared memory (as
// f32) one K chunk at a time (all of K = 2048 at once for decode tiles);
// lane partial sums are reduced with warp shuffles and then through shared
// memory. A ragged N (N % 4 != 0, GPT-2's 50257-wide lm_head) leaves the
// rows of the packed weight unaligned: the launcher then takes the VEC =
// false build, whose threads read their 4 columns byte by byte (bf16 by bf16
// for the scales), the columns past N as 0; only columns below N are
// written. The aligned build (VEC = true) keeps the vector loads, so ragged
// support costs aligned shapes nothing. Where a grid would not fill the
// card (decode shapes), K is also
// split across blocks: each writes f32 partial sums and a small second
// launch (dq_finish) adds them and applies the epilogue. This is a
// weight-streaming GEMV for the 8-row tiles of decode, where the bytes of W
// bound the call; K1's prefill path (M > 8) is dq_mma_kernel in
// dequant_matmul.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtpu {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int chunk_k(int group, int cap) {
  // K values staged per chunk: the largest multiple of the group up to cap
  return group >= cap ? group : group * (cap / group);
}

// Activation chunk: up to 2048 K values per row (64 KB of f32 for 8 rows),
// so a 2048-wide K needs one chunk and one barrier pair.
constexpr int kChunkCap = 2048;

constexpr int kUnroll = 8;  // packed-row loads a thread keeps in flight

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The 4 adjacent bytes at p, for columns n .. n + 3 of an N-wide row: one
// 32-bit load in the aligned build (VEC: N and the row pitch are multiples
// of 4, so n + 3 < N), else byte loads with the columns past N read as 0.
template <bool VEC>
__device__ __forceinline__ uint32_t ld_cols4_u8(const int8_t* p, int n, int N) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (n + t < N) w |= (uint32_t)(uint8_t)__ldg(p + t) << (8 * t);
  return w;
}

// The same for 4 bf16 values, as f32 (one 8-byte load when VEC).
template <bool VEC>
__device__ __forceinline__ void ld_cols4_bf16(const __nv_bfloat16* p, int n, int N, float* out) {
  if constexpr (VEC) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int t = 0; t < 4; ++t) out[t] = __bfloat162float(b[t]);
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) out[t] = n + t < N ? __bfloat162float(p[t]) : 0.f;
}

// What a MODE (below) adds around the dot: an rms-norm prologue on x, the
// SwiGLU pairing of gate and up columns (two column sets), a residual in the
// epilogue. Each MODE is its own template instance, so an instance compiles
// only its own parts.
template <int MODE>
struct Mode {
  static constexpr bool kNorm = MODE == 1 || MODE == 4 || MODE == 6;
  static constexpr bool kPair = MODE == 1;
  static constexpr bool kResid = MODE == 2 || MODE == 6;
  static constexpr int kSets = kPair ? 2 : 1;
};

struct DqArgs {
  const __nv_bfloat16* x;       // [M, K] activations
  const int8_t* data;           // [K / PK, ldw] packed weight
  const __nv_bfloat16* scales;  // [K / group, ldw]
  const uint8_t* zeros;         // [K / group, ldw] or nullptr (symmetric)
  const __nv_bfloat16* nw;      // MODE 1, 4, 6: rms-norm weight [K]
  const __nv_bfloat16* resid;   // MODE 2, 6: residual [M, N]
  const float* cb;              // MODE 3: level table [16] f32 (codebook)
  __nv_bfloat16* out;           // [M, N]
  float* part;                  // split K: f32 partial sums [splits][NSET][M][N], else nullptr
  int M, K, N;                  // N: output columns (MODE 1: F of a [K, 2F] weight)
  int ldw;                      // columns of the packed weight
  int group;
  int split_groups;             // groups of K per K slice (all of K when not split)
  float eps;
};

// The output of one element from its f32 sums v[NSET] (see MODE below).
template <int MODE>
__device__ __forceinline__ __nv_bfloat16 epilogue(const float* v, const DqArgs& a, size_t o) {
  if (Mode<MODE>::kPair) {
    const float gt = v[0];
    const float silu = gt * (1.0f / (1.0f + expf(-gt)));
    return __float2bfloat16(round_bf16(silu) * round_bf16(v[1]));
  }
  if (Mode<MODE>::kResid) return __float2bfloat16(v[0] + bf2f(a.resid[o]));
  return __float2bfloat16(v[0]);
}

// MODE 0: out = x @ W.
// MODE 1: out = bf16(silu(h @ Wg)) * bf16(h @ Wu), h = bf16(rms_norm(x) * nw),
//         with gate columns [0, N) and up columns [N, 2N) of one weight.
// MODE 2: out = bf16(x @ W + resid), the residual added in f32.
// MODE 3: out = x @ W with W = cb[q] * s (POT/APOT codebook, zeros unused);
//         the 16 levels sit in shared memory, each a distinct bank.
// MODE 4: out = h @ W, h = bf16(rms_norm(x) * nw) (K1's norm_w option).
// MODE 6: out = bf16(h @ W + resid), h as in MODE 4 (both K1 options).
// dq_tile computes the output tile (tn, tm): columns tn * BN .., rows
// tm * TM ..; dq_body is the tile of the block (blockIdx.x, blockIdx.y).
// With a.part set, K slice `zs` (blockIdx.z for dq_kernel) sums only its
// a.split_groups groups of K and writes raw f32 sums; dq_finish adds the
// splits and applies the epilogue. The body is a device function so that the
// expert kernels of moe_matmul.cu run it on one expert's pointers, and K13's
// cooperative kernel on the tiles of each of its phases. XC: x is read
// through L2 (__ldcg) instead of the read-only cache, for an x that other
// blocks of the same launch wrote (K13).
template <int BITS, int TM, int CQ, int MODE, bool VEC = true, bool XC = false>
__device__ __forceinline__ void dq_tile(const DqArgs& a, int tn, int tm, int zs) {
  constexpr int PK = 8 / BITS;
  constexpr int LANES = kThreads / CQ;
  constexpr int BN = 4 * CQ;
  constexpr int NSET = Mode<MODE>::kSets;
  constexpr int Z_SYM = 1 << (BITS - 1);
  extern __shared__ float smem[];
  __shared__ float inv_rms[TM];
  __shared__ float lut[16];

  const int tid = threadIdx.x;
  const int cq = tid % CQ;
  const int lane = tid / CQ;
  const int m0 = tm * TM;
  const int col0 = tn * BN;
  const int n0 = col0 + 4 * cq;  // first of this thread's 4 columns
  const bool col_ok = n0 < a.N;
  const int g = a.group;
  const int R = g / PK;  // packed rows per group
  const int KC = chunk_k(g, kChunkCap);
  float* xs = smem;  // [TM][KC]

  if (MODE == 3 && tid < 16) lut[tid] = a.cb[tid];  // read after the chunk loop's barrier
  if (Mode<MODE>::kNorm) {
    const int warp = tid / 32, wl = tid % 32;
    for (int m = warp; m < TM; m += kWarps) {
      float ss = 0.f;
      if (m0 + m < a.M) {
        const __nv_bfloat16* xr = a.x + (size_t)(m0 + m) * a.K;
        for (int k = wl; k < a.K; k += 32) {
          float v = bf2f(xr[k]);
          ss += v * v;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (wl == 0) inv_rms[m] = 1.0f / sqrtf(ss / (float)a.K + a.eps);
    }
    __syncthreads();
  }

  float acc[NSET][TM][4];
#pragma unroll
  for (int s = 0; s < NSET; ++s)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[s][m][t] = 0.f;

  const int kbeg = zs * a.split_groups * g;
  const int kend = min(a.K, kbeg + a.split_groups * g);
  for (int kc0 = kbeg; kc0 < kend; kc0 += KC) {
    const int klen = min(KC, kend - kc0);
    __syncthreads();  // the previous chunk is consumed
    // 4 activations per 8-byte load (K, the chunk and the group are multiples of 4)
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const bool row_ok = m0 + m < a.M;
      const __nv_bfloat16* xr = a.x + (size_t)(m0 + m) * a.K + kc0;
      for (int kk = 4 * tid; kk < klen; kk += 4 * kThreads) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (row_ok) {
          uint2 raw;
          if constexpr (XC) raw = __ldcg(reinterpret_cast<const uint2*>(xr + kk));
          else raw = __ldg(reinterpret_cast<const uint2*>(xr + kk));
          const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int t = 0; t < 4; ++t) v[t] = bf2f(xb[t]);
          if (Mode<MODE>::kNorm) {
            const uint2 wraw = __ldg(reinterpret_cast<const uint2*>(a.nw + kc0 + kk));
            const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&wraw);
#pragma unroll
            for (int t = 0; t < 4; ++t) v[t] = round_bf16(v[t] * inv_rms[m] * bf2f(wb[t]));
          }
        }
        *reinterpret_cast<float4*>(xs + m * KC + kk) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    if (!col_ok) continue;
    const int nrows = klen / PK;
    const int per = (nrows + LANES - 1) / LANES;
    const int rb = kc0 / PK + lane * per;
    const int re = min(kc0 / PK + nrows, rb + per);
    int cprev = -1;
    float s[NSET][4];
    int z[NSET][4];
    int c = rb / R;
    int j = rb - c * R;
    for (int r0 = rb; r0 < re; r0 += kUnroll) {
      uint32_t words[NSET][kUnroll];
#pragma unroll
      for (int set = 0; set < NSET; ++set)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          words[set][u] =
              r0 + u < re
                  ? ld_cols4_u8<VEC>(a.data + (size_t)(r0 + u) * a.ldw + n0 + set * a.N, n0, a.N)
                  : 0u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u >= re) break;
        if (c != cprev) {
          cprev = c;
#pragma unroll
          for (int set = 0; set < NSET; ++set) {
            const int col = n0 + set * a.N;
            ld_cols4_bf16<VEC>(a.scales + (size_t)c * a.ldw + col, n0, a.N, s[set]);
            if (MODE != 3 && a.zeros != nullptr) {
              const uint32_t zw = ld_cols4_u8<VEC>(
                  reinterpret_cast<const int8_t*>(a.zeros) + (size_t)c * a.ldw + col, n0, a.N);
#pragma unroll
              for (int t = 0; t < 4; ++t) z[set][t] = (zw >> (8 * t)) & 0xff;
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t) z[set][t] = Z_SYM;
            }
          }
        }
#pragma unroll
        for (int set = 0; set < NSET; ++set) {
          const uint32_t word = words[set][u];
#pragma unroll
          for (int p = 0; p < PK; ++p) {
            float w[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const uint32_t b = (word >> (8 * t)) & 0xffu;
              int q;
              if (BITS == 8) {
                q = (int)(b ^ 0x80u);  // int8 value + 128
              } else if (BITS == 4) {
                q = p == 0 ? (int)(b & 0xfu) : (int)((b >> 4) ^ 8u);
              } else {
                q = (int)((b >> (2 * p)) & 3u);
              }
              w[t] = MODE == 3 ? lut[q] * s[set][t] : (float)(q - z[set][t]) * s[set][t];
            }
            const float* xr = xs + (c * g + p * R + j - kc0);
#pragma unroll
            for (int m = 0; m < TM; ++m) {
              const float xv = xr[m * KC];
#pragma unroll
              for (int t = 0; t < 4; ++t) acc[set][m][t] = fmaf(xv, w[t], acc[set][m][t]);
            }
          }
        }
        if (++j == R) {
          j = 0;
          ++c;
        }
      }
    }
  }

  // reduce the lanes: first inside each warp, then across the warps
#pragma unroll
  for (int o = CQ; o < 32; o <<= 1)
#pragma unroll
    for (int s = 0; s < NSET; ++s)
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc[s][m][t] += __shfl_xor_sync(0xffffffffu, acc[s][m][t], o);
  __syncthreads();
  float* red = smem;  // [kWarps][NSET][TM][BN]
  const int warp = tid / 32;
  if ((tid % 32) < CQ) {
#pragma unroll
    for (int s = 0; s < NSET; ++s)
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          red[((warp * NSET + s) * TM + m) * BN + 4 * cq + t] = acc[s][m][t];
  }
  __syncthreads();
  for (int i = tid; i < TM * BN; i += kThreads) {
    const int m = i / BN;
    const int cc = i - m * BN;
    const int n = col0 + cc;
    if (m0 + m >= a.M || n >= a.N) continue;
    float v[NSET];
#pragma unroll
    for (int s = 0; s < NSET; ++s) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[((w * NSET + s) * TM + m) * BN + cc];
      v[s] = sum;
    }
    const size_t o = (size_t)(m0 + m) * a.N + n;
    if (a.part != nullptr) {
#pragma unroll
      for (int s = 0; s < NSET; ++s)
        a.part[((size_t)(zs * NSET + s) * a.M + m0 + m) * a.N + n] = v[s];
    } else {
      a.out[o] = epilogue<MODE>(v, a, o);
    }
  }
}

template <int BITS, int TM, int CQ, int MODE, bool VEC = true>
__device__ __forceinline__ void dq_body(const DqArgs& a, int zs) {
  dq_tile<BITS, TM, CQ, MODE, VEC>(a, blockIdx.x, blockIdx.y, zs);
}

template <int BITS, int TM, int CQ, int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads) dq_kernel(DqArgs a) {
  dq_body<BITS, TM, CQ, MODE, VEC>(a, blockIdx.z);
}

// Sums the split-K partials of dq_kernel and applies the epilogue.
template <int MODE>
__global__ void __launch_bounds__(kThreads) dq_finish(DqArgs a, int splits) {
  constexpr int NSET = Mode<MODE>::kSets;
  const size_t mn = (size_t)a.M * a.N;
  for (size_t o = blockIdx.x * (size_t)kThreads + threadIdx.x; o < mn;
       o += (size_t)gridDim.x * kThreads) {
    float v[NSET];
#pragma unroll
    for (int s = 0; s < NSET; ++s) {
      float sum = 0.f;
      for (int z = 0; z < splits; ++z) sum += a.part[(size_t)(z * NSET + s) * mn + o];
      v[s] = sum;
    }
    a.out[o] = epilogue<MODE>(v, a, o);
  }
}

template <int BITS, int TM, int CQ, int MODE>
inline size_t dq_smem_bytes(int group) {
  constexpr int NSET = Mode<MODE>::kSets;
  const size_t xs = (size_t)TM * chunk_k(group, kChunkCap) * sizeof(float);
  const size_t red = (size_t)kWarps * NSET * TM * 4 * CQ * sizeof(float);
  return xs > red ? xs : red;
}

// Launches dq_kernel on `stream` over the slices of K that a.split_groups
// gives, as the caller chose them (ceil(groups / split_groups) slices; a.part
// holds slices * NSET * M * N floats when there is more than one), then
// dq_finish if split. VEC = false is the build for N % 4 != 0 (ragged rows).
// Returns the cudaError_t of the launches, or -1 for arguments it does not
// take. static: each library keeps its own record of the shared memory it
// allowed its own kernel (an inline function's static would be one object
// across the libraries loaded in a process).
template <int BITS, int TM, int CQ, int MODE, bool VEC = true>
static inline int launch_dq(DqArgs a, cudaStream_t stream) {
  constexpr int BN = 4 * CQ;
  static size_t smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  const size_t smem = dq_smem_bytes<BITS, TM, CQ, MODE>(a.group);
  const int groups = a.K / a.group;
  if (smem > 227 * 1024 || a.split_groups < 1 || a.split_groups > groups) return -1;
  if (VEC && (a.N % 4 != 0 || a.ldw % 4 != 0)) return -1;
  const int splits = (groups + a.split_groups - 1) / a.split_groups;
  if (splits == 1) a.part = nullptr;
  else if (a.part == nullptr) return -1;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(dq_kernel<BITS, TM, CQ, MODE, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((a.N + BN - 1) / BN, (a.M + TM - 1) / TM, splits);
  dq_kernel<BITS, TM, CQ, MODE, VEC><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t mn = (size_t)a.M * a.N;
  const int blocks = (int)((mn + kThreads - 1) / kThreads < 1024 ? (mn + kThreads - 1) / kThreads : 1024);
  dq_finish<MODE><<<blocks, kThreads, 0, stream>>>(a, splits);
  return (int)cudaGetLastError();
}

}  // namespace qtpu
