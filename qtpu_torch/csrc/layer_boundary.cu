// K13: everything between two attentions of a decode step in one launch.
//
// Replaces the TPU kernel pallas_layer_boundary_stacked
// (qtpu/kernels/pallas_layer_boundary.py:139). For a decode batch of M <= 32
// rows, with layer l's o/gateup/down sites and layer l_next's fused qkv site
// (affine W4 or W8, one bits and group, K1's packed layout):
//   y   = x + attn @ Wo                      (f32, never rounded)
//   h   = bf16(rms_norm(y) * mlp_norm)
//   act = bf16(silu(h @ Wg)) * bf16(h @ Wu)  (bf16, as the TPU kernel rounds it)
//   y2  = y + act @ Wd                       (f32; written as bf16)
//   h2  = bf16(rms_norm(y2 f32) * attn_norm_next)
//   qkv = bf16(h2 @ Wqkv)
// The TPU kernel walks one sequential grid over the three weight streams and
// carries y, h, the MLP accumulator and h2 in VMEM scratch from one grid step
// to the next. Blocks on the GPU run in no order and carry nothing, so this
// is one cooperative launch (every block resident at once, its grid sized
// from the occupancy of this kernel) whose blocks walk the tiles of each
// phase and meet at a grid barrier between phases:
//   1. O: split-K tiles of K1's GEMV body (dq_core.cuh, MODE 0) write f32
//      partial sums;
//   2. one block a row: y = x + the partials (in slice order), rms, h;
//   3. gate/up: split-K partials of h @ [Wg | Wu] (2F columns);
//   4. act = bf16(silu(gate)) * bf16(up) from the summed partials, [M, F];
//   5. down: split-K partials over F;
//   6. one block a row: y2 = y + the partials, written as bf16; rms of the
//      f32 y2, h2;
//   7. qkv: split-K partials over D, or the output itself with one slice;
//   8. (with more than one slice) the partials summed in slice order, cast.
// Every matmul phase is the plain GEMV body, so the kernel keeps its
// registers (and blocks per SM) and splits every phase's K as finely as the
// caller's plan balances its tiles over the grid.
// Sums across blocks go through f32 scratch in a fixed order, never float
// atomics, so the result does not depend on the schedule. Activations made
// inside the launch are read back through L2 (__ldcg; dq_tile's XC), not the
// read-only cache. The phase-clamped index maps, the VMEM block budget and
// the scalar prefetch of the TPU kernel have no counterpart: the caller
// passes the two layers' views of the stacked weights. The last layer's qkv
// (layer l_next = l) is computed as on the TPU, and thrown away by the model.
// Bound on an H100: the packed bytes of the four sites (about 23 MB a layer at
// TinyLlama W4 g128); the activations and the f32 scratch are below 1 MB at
// M = 8.
#include <cooperative_groups.h>

#include "dq_core.cuh"

namespace cg = cooperative_groups;
using namespace qtpu;

namespace {

constexpr int kTM = 8;  // rows of a tile
constexpr int kCQ = 8;  // 4-column quads of a tile: 32 columns

struct LbArgs {
  DqArgs o, gu, d, q;        // the four phases' matmuls (x, weights, out or part)
  const __nv_bfloat16* x;    // [M, D] residual in
  const __nv_bfloat16* mn;   // [D] mlp_norm of layer l
  const __nv_bfloat16* an;   // [D] attn_norm of layer l_next
  float* y;                  // [M, D] f32 scratch: y, then y2
  __nv_bfloat16* y2;         // [M, D] out
  int splits_o, splits_gu, splits_d, splits_q;
  float eps;
};

// Every tile (column tile, row tile, K slice) of one phase, spread over the
// blocks of the grid.
template <int BITS, int MODE>
__device__ __forceinline__ void run_tiles(const DqArgs& a, int splits) {
  const int nt = (a.N + 4 * kCQ - 1) / (4 * kCQ);
  const int mt = (a.M + kTM - 1) / kTM;
  const int total = nt * mt * splits;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int r = t / nt;
    dq_tile<BITS, kTM, kCQ, MODE, true, true>(a, t - r * nt, r % mt, r / mt);
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// Row phases (2 and 5), one block a row: v = base + the `splits` partials in
// order; yf = v (f32), out = bf16(v) when given; then h = bf16(v * rsqrt(
// mean(v^2) + eps) * w). base is x (bf16) or, with x_base null, yf itself.
__device__ void row_phase(const float* part, int splits, int M, int N,
                          const __nv_bfloat16* x_base, float* yf, __nv_bfloat16* out,
                          const __nv_bfloat16* w, __nv_bfloat16* h, float eps) {
  __shared__ float red[kWarps];
  const size_t mn = (size_t)M * N;
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    float ss = 0.f;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const size_t o = (size_t)m * N + n;
      float acc = 0.f;
      for (int z = 0; z < splits; ++z) acc += __ldcg(part + z * mn + o);
      const float v = (x_base != nullptr ? bf2f(x_base[o]) : yf[o]) + acc;
      yf[o] = v;
      if (out != nullptr) out[o] = __float2bfloat16(v);
      ss += v * v;
    }
    const float inv = 1.0f / sqrtf(block_sum(ss, red) / (float)N + eps);
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const size_t o = (size_t)m * N + n;
      h[o] = __float2bfloat16(yf[o] * inv * bf2f(w[n]));
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads) boundary_kernel(LbArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int M = p.o.M, D = p.o.N;
  run_tiles<BITS, 0>(p.o, p.splits_o);
  grid.sync();
  row_phase(p.o.part, p.splits_o, M, D, p.x, p.y, nullptr, p.mn,
            const_cast<__nv_bfloat16*>(p.gu.x), p.eps);
  grid.sync();
  run_tiles<BITS, 0>(p.gu, p.splits_gu);
  grid.sync();
  {  // act = bf16(silu(gate)) * bf16(up), gate columns [0, F), up [F, 2F)
    const int F = p.d.K;
    const size_t mf = (size_t)M * F, m2f = 2 * mf;
    __nv_bfloat16* act = const_cast<__nv_bfloat16*>(p.d.x);
    for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < mf;
         i += (size_t)gridDim.x * kThreads) {
      const size_t o = (i / F) * 2 * F + i % F;
      float v[2] = {0.f, 0.f};
      for (int z = 0; z < p.splits_gu; ++z) {
        v[0] += __ldcg(p.gu.part + z * m2f + o);
        v[1] += __ldcg(p.gu.part + z * m2f + o + F);
      }
      act[i] = epilogue<1>(v, p.gu, i);  // K4's pairing of the two sums
    }
  }
  grid.sync();
  run_tiles<BITS, 0>(p.d, p.splits_d);
  grid.sync();
  row_phase(p.d.part, p.splits_d, M, D, nullptr, p.y, p.y2, p.an,
            const_cast<__nv_bfloat16*>(p.q.x), p.eps);
  grid.sync();
  run_tiles<BITS, 0>(p.q, p.splits_q);
  if (p.splits_q > 1) {
    grid.sync();
    const size_t mn = (size_t)M * p.q.N;
    for (size_t o = blockIdx.x * (size_t)kThreads + threadIdx.x; o < mn;
         o += (size_t)gridDim.x * kThreads) {
      float acc = 0.f;
      for (int z = 0; z < p.splits_q; ++z) acc += __ldcg(p.q.part + z * mn + o);
      p.q.out[o] = __float2bfloat16(acc);
    }
  }
}

template <int BITS>
size_t smem_bytes(int group) {
  return dq_smem_bytes<BITS, kTM, kCQ, 0>(group);
}

// Blocks of the cooperative grid: as many as can be resident at once.
template <int BITS>
int grid_blocks(int group) {
  const size_t smem = smem_bytes<BITS>(group);
  if (smem > 227 * 1024) return -1;
  cudaError_t e = cudaFuncSetAttribute(boundary_kernel<BITS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boundary_kernel<BITS>, kThreads,
                                                    smem);
  if (e != cudaSuccess) return -(int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)e;
  return per_sm * sms;  // 0 when not one block fits: the caller raises
}

template <int BITS>
int launch(LbArgs p, int blocks, cudaStream_t st) {
  const size_t smem = smem_bytes<BITS>(p.o.group);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)boundary_kernel<BITS>,
                                              dim3(blocks), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

DqArgs site(const void* x, const void* data, const void* scales, const void* zeros, void* out,
            float* part, int split_groups, int M, int K, int N, int ldw, int group) {
  DqArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.data = static_cast<const int8_t*>(data);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.zeros = static_cast<const uint8_t*>(zeros);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = part;
  a.M = M;
  a.K = K;
  a.N = N;
  a.ldw = ldw;
  a.group = group;
  a.split_groups = split_groups;
  return a;
}

}  // namespace

// The cooperative grid of K13 for this packing (blocks resident at once on
// the current device), 0 when none fits, or a negative error.
extern "C" int qtpu_layer_boundary_grid(int bits, int group) {
  if (group <= 0 || group % 4 != 0) return -1;
  switch (bits) {
    case 4: return grid_blocks<4>(group);
    case 8: return grid_blocks<8>(group);
    default: return -1;
  }
}

// attn [M, Q], x [M, D], mn/an [D] bf16; o [Q/PK, D], gu [D/PK, 2F], d [F/PK,
// D], q [D/PK, Nq] packed with bf16 scales and uint8 zeros [K/g, N]; outputs
// y2 [M, D], qkv [M, Nq] bf16. Scratch: y [M, D] f32; h, h2 [M, D] and act
// [M, F] bf16; part_o [so, M, D], part_gu [sgu, M, 2F], part_d [sd, M, D],
// part_q [sq, M, Nq] f32 (null for sq = 1), the slices so = ceil(Q/g /
// per_o) and so on. blocks: qtpu_layer_boundary_grid's count or fewer.
// Returns a cudaError_t (0 on success), or -1 for arguments the kernel does
// not take.
extern "C" int qtpu_layer_boundary(
    const void* attn, const void* x, const void* mn, const void* an,
    const void* o_data, const void* o_scales, const void* o_zeros,
    const void* gu_data, const void* gu_scales, const void* gu_zeros,
    const void* d_data, const void* d_scales, const void* d_zeros,
    const void* q_data, const void* q_scales, const void* q_zeros,
    void* y2, void* qkv, void* y, void* h, void* act, void* h2,
    void* part_o, void* part_gu, void* part_d, void* part_q,
    int per_o, int per_gu, int per_d, int per_q, int blocks,
    int M, int Q, int D, int F, int Nq, int bits, int group, float eps, void* stream) {
  if (M <= 0 || M > 32 || blocks <= 0 || group <= 0 || group % 4 != 0 || Q % group != 0 ||
      D % group != 0 || F % group != 0 || Nq % 4 != 0 || o_zeros == nullptr ||
      gu_zeros == nullptr || d_zeros == nullptr || q_zeros == nullptr || part_o == nullptr ||
      part_gu == nullptr || part_d == nullptr)
    return -1;
  if (per_o < 1 || per_gu < 1 || per_d < 1 || per_q < 1) return -1;
  const int so = (Q / group + per_o - 1) / per_o;
  const int sgu = (D / group + per_gu - 1) / per_gu;
  const int sd = (F / group + per_d - 1) / per_d;
  const int sq = (D / group + per_q - 1) / per_q;
  if (sq > 1 && part_q == nullptr) return -1;
  LbArgs p{};
  p.o = site(attn, o_data, o_scales, o_zeros, nullptr, static_cast<float*>(part_o), per_o, M, Q,
             D, D, group);
  p.gu = site(h, gu_data, gu_scales, gu_zeros, nullptr, static_cast<float*>(part_gu), per_gu, M,
              D, 2 * F, 2 * F, group);
  p.d = site(act, d_data, d_scales, d_zeros, nullptr, static_cast<float*>(part_d), per_d, M, F,
             D, D, group);
  p.q = site(h2, q_data, q_scales, q_zeros, qkv, sq > 1 ? static_cast<float*>(part_q) : nullptr,
             per_q, M, D, Nq, Nq, group);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.mn = static_cast<const __nv_bfloat16*>(mn);
  p.an = static_cast<const __nv_bfloat16*>(an);
  p.y = static_cast<float*>(y);
  p.y2 = static_cast<__nv_bfloat16*>(y2);
  p.splits_o = so;
  p.splits_gu = sgu;
  p.splits_d = sd;
  p.splits_q = sq;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 4: return launch<4>(p, blocks, st);
    case 8: return launch<8>(p, blocks, st);
    default: return -1;
  }
}
