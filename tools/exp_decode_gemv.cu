// Kernels of tools/exp_decode_gemv.py: what bounds the decode GEMV body of
// qtpu_torch/csrc/dq_core.cuh (dq_tile at M <= 8), at the shapes K9 and K1
// run it at decode. Built by the script with nvcc (-I qtpu_torch/csrc).
//
//   exp_dq        the current body (dq_core.cuh's dq_body, MODE 0, W4, the
//                 vector-load build) over E experts, split K as the wrappers
//                 split it, then the sum of the split partials;
//   exp_nofma     the same launch with dq_tile's products removed: every load
//                 (the activations into shared memory, the packed words, the
//                 scales and zeros) and every dequantization stays, and each
//                 dequantized weight is folded into one f32 sum a column
//                 instead of 8 FMAs (one a row of x);
//   exp_stream    the same packed bytes read once with 16-byte loads, 8 in
//                 flight a thread, and nothing computed (an xor fold).
#include "dq_core.cuh"

using namespace qtpu;

namespace {

struct Ex {
  int E, splits;
  long long w_es, s_es, o_es, p_es, x_es;
};

__device__ __forceinline__ bool expert(DqArgs& a, const Ex& m, int& zs) {
  const int e = blockIdx.z / m.splits;
  zs = blockIdx.z - e * m.splits;
  if (e >= m.E) return false;
  a.x += (size_t)e * m.x_es;
  a.data += (size_t)e * m.w_es;
  a.scales += (size_t)e * m.s_es;
  if (a.zeros != nullptr) a.zeros += (size_t)e * m.s_es;
  a.out += (size_t)e * m.o_es;
  if (a.part != nullptr) a.part += (size_t)e * m.p_es;
  return true;
}

// dq_tile<4, 8, 8, 0, true> with the products x * w removed (see the note).
__device__ __forceinline__ void nofma_tile(const DqArgs& a, int tn, int zs) {
  constexpr int TM = 8, CQ = 8, PK = 2, LANES = kThreads / CQ, BN = 4 * CQ;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int cq = tid % CQ;
  const int lane = tid / CQ;
  const int n0 = tn * BN + 4 * cq;
  const int g = a.group;
  const int R = g / PK;
  const int KC = chunk_k(g, kChunkCap);
  float* xs = smem;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int kbeg = zs * a.split_groups * g;
  const int kend = min(a.K, kbeg + a.split_groups * g);
  for (int kc0 = kbeg; kc0 < kend; kc0 += KC) {
    const int klen = min(KC, kend - kc0);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const __nv_bfloat16* xr = a.x + (size_t)m * a.K + kc0;
      for (int kk = 4 * tid; kk < klen; kk += 4 * kThreads) {
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m < a.M) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(xr + kk));
          const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int t = 0; t < 4; ++t) v[t] = bf2f(xb[t]);
        }
        *reinterpret_cast<float4*>(xs + m * KC + kk) = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    if (n0 >= a.N) continue;
    const int nrows = klen / PK;
    const int per = (nrows + LANES - 1) / LANES;
    const int rb = kc0 / PK + lane * per;
    const int re = min(kc0 / PK + nrows, rb + per);
    int cprev = -1, c = rb / R, j = rb - c * R;
    float s[4];
    int z[4];
    for (int r0 = rb; r0 < re; r0 += kUnroll) {
      uint32_t words[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        words[u] = r0 + u < re ? ld_cols4_u8<true>(a.data + (size_t)(r0 + u) * a.ldw + n0, n0, a.N)
                               : 0u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u >= re) break;
        if (c != cprev) {
          cprev = c;
          ld_cols4_bf16<true>(a.scales + (size_t)c * a.ldw + n0, n0, a.N, s);
          const uint32_t zw = ld_cols4_u8<true>(
              reinterpret_cast<const int8_t*>(a.zeros) + (size_t)c * a.ldw + n0, n0, a.N);
#pragma unroll
          for (int t = 0; t < 4; ++t) z[t] = (zw >> (8 * t)) & 0xff;
        }
#pragma unroll
        for (int p = 0; p < PK; ++p) {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const uint32_t b = (words[u] >> (8 * t)) & 0xffu;
            const int q = p == 0 ? (int)(b & 0xfu) : (int)((b >> 4) ^ 8u);
            acc[t] += (float)(q - z[t]) * s[t];
          }
        }
        if (++j == R) {
          j = 0;
          ++c;
        }
      }
    }
  }
  if (n0 < a.N && lane == 0) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (a.part != nullptr) a.part[(size_t)zs * a.M * a.N + n0 + t] = acc[t];
      else a.out[n0 + t] = __float2bfloat16(acc[t]);
    }
  }
}

template <bool NOFMA>
__global__ void __launch_bounds__(kThreads) exp_dq_kernel(DqArgs a, Ex m) {
  DqArgs b = a;
  int zs;
  if (!expert(b, m, zs)) return;
  if constexpr (NOFMA) nofma_tile(b, blockIdx.x, zs);
  else dq_body<4, 8, 8, 0, true>(b, zs);
}

__global__ void __launch_bounds__(kThreads) exp_finish(const float* part, __nv_bfloat16* out,
                                                       size_t mn, int experts, int splits) {
  const size_t total = mn * experts;
  for (size_t o = blockIdx.x * (size_t)kThreads + threadIdx.x; o < total;
       o += (size_t)gridDim.x * kThreads) {
    const size_t e = o / mn, r = o - e * mn;
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[(e * splits + z) * mn + r];
    out[o] = __float2bfloat16(sum);
  }
}

__global__ void __launch_bounds__(256) exp_stream_kernel(const uint4* p, size_t n16, uint32_t* sink) {
  uint32_t acc = 0;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  for (; i + 7 * stride < n16; i += 8 * stride) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = __ldcs(p + i + u * stride);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  for (; i < n16; i += stride) {
    const uint4 v = __ldcs(p + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;  // keeps the loads; practically never stored
}

}  // namespace

// E experts of a W4 [K / 2, N] site (x shared or per expert), the current
// body (nofma 0) or its product-free copy (nofma 1), split as the wrapper
// splits it: split_groups groups a slice, part [E, slices, M, N] f32.
extern "C" int exp_dq(const void* x, int per_expert, const void* data, const void* scales,
                      const void* zeros, void* out, void* part, int split_groups, int E, int M,
                      int K, int N, int group, int nofma, void* stream) {
  DqArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.data = static_cast<const int8_t*>(data);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.zeros = static_cast<const uint8_t*>(zeros);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.K = K;
  a.N = N;
  a.ldw = N;
  a.group = group;
  a.split_groups = split_groups;
  const int groups = K / group;
  const int splits = (groups + split_groups - 1) / split_groups;
  if (splits == 1) a.part = nullptr;
  Ex m{E, splits, (long long)K / 2 * N, (long long)(K / group) * N, (long long)M * N,
       (long long)splits * M * N, per_expert ? (long long)M * K : 0};
  const size_t smem = dq_smem_bytes<4, 8, 8, 0>(group);
  auto kernel = nofma ? exp_dq_kernel<true> : exp_dq_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((N + 31) / 32, 1, E * splits), kThreads, smem, st>>>(a, m);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  exp_finish<<<1024, kThreads, 0, st>>>(a.part, a.out, (size_t)M * N, E, splits);
  return (int)cudaGetLastError();
}

// Reads `bytes` (a multiple of 16) at p once; grid of `blocks` x 256.
extern "C" int exp_stream(const void* p, long long bytes, void* sink, int blocks, void* stream) {
  exp_stream_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), (size_t)bytes / 16, static_cast<uint32_t*>(sink));
  return (int)cudaGetLastError();
}
