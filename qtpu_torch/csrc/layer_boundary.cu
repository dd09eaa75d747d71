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
//   1. O: split-K tiles write f32 partial sums;
//   2. y = x + the partials (in slice order), rms, h (one block a row in
//      dq_tile's build; in the tensor-core build two passes over the whole
//      grid, a barrier between: the sums and each 128-column chunk's sum of
//      squares, then h);
//   3. gate/up: split-K partials of h @ [Wg | Wu] (2F columns);
//   4. act = bf16(silu(gate)) * bf16(up) from the summed partials, [M, F];
//   5. down: split-K partials over F;
//   6. as 2: y2 = y + the partials, written as bf16; rms of the f32 y2, h2;
//   7. qkv: split-K partials over D, or the output itself with one slice;
//   8. (with more than one slice) the partials summed in slice order, cast.
// A matmul phase's tile is an output column strip by one 8-row tile of the
// M rows by one K slice of whole groups; the caller's plan (_slices in
// qtpu_torch/kernels/layer_boundary.py) balances each phase's tiles over the
// grid. The tiles run the tensor-core step of the decode GEMV
// (dq_gemv_tc.cuh's gtc_block: 128 columns, mma.sync m16n8k16 with the
// weight as A, the weight streamed by 16-byte cp.async into a per-lane ring,
// 4 warps a block) where lb_tc_fits holds (W4/W8, g64/g128, every width a
// multiple of 16, the tensors 16-byte aligned, slices of at most kTcSlice K
// values); else, and behind the entry's `tc` = 0 (the "was" times of
// layer_boundary_dq), the first version's tiles: 32 columns of dq_core.cuh's
// SIMT dq_tile, 256 threads a block, and the row phases' first version.
// Sums across blocks go through f32 scratch in a fixed order, never float
// atomics, so the result does not depend on the schedule. Activations made
// inside the launch are read back through L2 (__ldcg, dq_tile's XC, or
// cp.async), not the read-only cache. The phase-clamped index maps, the VMEM
// block budget and the scalar prefetch of the TPU kernel have no
// counterpart: the caller passes the two layers' views of the stacked
// weights. The last layer's qkv
// (layer l_next = l) is computed as on the TPU, and thrown away by the model.
// Bound on an H100: the packed bytes of the four sites (about 23 MB a layer at
// TinyLlama W4 g128, 6.9 us at 3.35 TB/s); the activations and the f32
// scratch are below 2 MB at M = 8. dq_tile spends 8 f32 FMAs a weight, more
// than the SIMT lanes issue at the memory's rate (dq_gemv_tc.cuh's note); the
// tensor-core step spends about 3 instructions a weight byte and 1/4 of an
// mma, which leaves the phases' bytes, the grid barriers and each tile's
// fixed latency (its first loads, the reduction, the partials' write).
#include <cooperative_groups.h>

#include "dq_gemv_tc.cuh"

namespace cg = cooperative_groups;
// Using-declarations, not `using namespace qtpu`: dq_gemv_tc.cuh's helpers
// live in an anonymous namespace inside qtpu, which would make this file's
// own anonymous namespace (its kernel) ambiguous in nvcc's launch stubs.
using qtpu::bf2f;
using qtpu::dq_smem_bytes;
using qtpu::dq_tile;
using qtpu::DqArgs;
using qtpu::epilogue;
using qtpu::gtc_block;
using qtpu::gtc_smem_u32;
using qtpu::gtc_sums;
using qtpu::kTcCols;
using qtpu::TcLayout;

namespace {

constexpr int kTM = 8;          // rows of a tile
constexpr int kCQ = 8;          // dq_tile: 4-column quads of a tile, 32 columns
constexpr int kTcSlice = 1024;  // tensor-core tiles: the most K values of a slice (x's stage)

// Threads a block: the tensor-core tiles' 4 warps, or dq_tile's 256.
template <bool TC>
struct Lb {
  static constexpr int kThreads = TC ? TcLayout<4, 0>::THREADS : qtpu::kThreads;
  // blocks an SM the registers allow. The tensor-core build: 3 (170 a
  // thread; W4 spills nothing, W8 36 bytes, against 56 and 140 at 4), and 3
  // x 132 blocks meet at a grid barrier sooner than 4 x 132 (TinyLlama W4
  // M 8 58.8 against 70.5 us on an H100, tools/exp_w8a8_k13.py). dq_tile's
  // build: 2 (128 a thread), what its first version compiled to (at 1 it
  // takes 164 and runs 137.0 us against 106.3 at M 8, the same tool)
  static constexpr int kMinBlocks = TC ? 3 : 2;
};

struct LbArgs {
  DqArgs o, gu, d, q;        // the four phases' matmuls (x, weights, out or part)
  const __nv_bfloat16* x;    // [M, D] residual in
  const __nv_bfloat16* mn;   // [D] mlp_norm of layer l
  const __nv_bfloat16* an;   // [D] attn_norm of layer l_next
  float* y;                  // [M, D] f32 scratch: y, then y2
  float* ssp;                // [M, ceil(D / 128)] f32: the tensor-core build's row sums
  __nv_bfloat16* y2;         // [M, D] out
  int splits_o, splits_gu, splits_d, splits_q;
  float eps;
};

// Every tile (column tile, row tile, K slice) of one phase, spread over the
// blocks of the grid: dq_tile's 32-column tiles.
template <int BITS>
__device__ __forceinline__ void run_tiles(const DqArgs& a, int splits) {
  const int nt = (a.N + 4 * kCQ - 1) / (4 * kCQ);
  const int mt = (a.M + kTM - 1) / kTM;
  const int total = nt * mt * splits;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int r = t / nt;
    dq_tile<BITS, kTM, kCQ, 0, true, true>(a, t - r * nt, r % mt, r / mt);
  }
}

// The same on the tensor-core step: gtc_block's kTcCols-column tiles, each
// writing its f32 sums to its slice's partials (or, with one slice, the
// bf16 output). x is staged by cp.async, which reads through L2: the
// activations other blocks wrote before the grid barrier.
template <int BITS>
__device__ __forceinline__ void run_tc_tiles(const DqArgs& a, int splits, uint8_t* base) {
  const int strips = (a.N + kTcCols - 1) / kTcCols;
  const int mt = (a.M + kTM - 1) / kTM;
  const int total = strips * mt * splits;
  const int groups = a.K / a.group;
  const float* sums = gtc_sums<BITS, 0>(base);
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int strip = t % strips;
    const int tm = (t / strips) % mt;
    const int z = t / (strips * mt);
    DqArgs b = a;
    b.x += (size_t)tm * kTM * a.K;
    b.M = min(kTM, a.M - tm * kTM);
    const int gb = z * a.split_groups;
    const int ge = min(groups, gb + a.split_groups);
    gtc_block<BITS, 0>(b, strip * kTcCols, gb * a.group, (ge - gb) * a.group,
                       a.split_groups * a.group + 8, base);
    __syncthreads();
    // (row m, column nl) of the tile in the warps' layout (dq_gemv_tc_kernel's
    // epilogue): o = (i 4 + e) 32 + lane holds column 16 (lane / 4) + 2 i +
    // e / 2, row 2 (lane % 4) + e % 2
    for (int idx = threadIdx.x; idx < kTM * kTcCols; idx += blockDim.x) {
      const int m = idx / kTcCols;
      const int nl = idx % kTcCols;
      const int n = strip * kTcCols + nl;
      if (m >= b.M || n >= a.N) continue;
      const int e = (nl & 1) << 1 | (m & 1);
      const int o = (((nl & 15) >> 1) * 4 + e) * 32 + 4 * (nl >> 4) + (m >> 1);
      const size_t row = (size_t)tm * kTM + m;
      if (a.part != nullptr) a.part[((size_t)z * a.M + row) * a.N + n] = sums[o];
      else a.out[row * a.N + n] = __float2bfloat16(sums[o]);
    }
    __syncthreads();  // the block's shared memory is free for its next tile
  }
}

template <int T>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// Row phases (2 and 5), one block a row: v = base + the `splits` partials in
// order; yf = v (f32), out = bf16(v) when given; then h = bf16(v * rsqrt(
// mean(v^2) + eps) * w). base is x (bf16) or, with x_base null, yf itself.
template <int T>
__device__ void row_phase(const float* part, int splits, int M, int N,
                          const __nv_bfloat16* x_base, float* yf, __nv_bfloat16* out,
                          const __nv_bfloat16* w, __nv_bfloat16* h, float eps) {
  __shared__ float red[T / 32];
  const size_t mn = (size_t)M * N;
  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    float ss = 0.f;
    for (int n = threadIdx.x; n < N; n += T) {
      const size_t o = (size_t)m * N + n;
      float acc = 0.f;
      for (int z = 0; z < splits; ++z) acc += __ldcg(part + z * mn + o);
      const float v = (x_base != nullptr ? bf2f(x_base[o]) : yf[o]) + acc;
      yf[o] = v;
      if (out != nullptr) out[o] = __float2bfloat16(v);
      ss += v * v;
    }
    const float inv = 1.0f / sqrtf(block_sum<T>(ss, red) / (float)N + eps);
    for (int n = threadIdx.x; n < N; n += T) {
      const size_t o = (size_t)m * N + n;
      h[o] = __float2bfloat16(yf[o] * inv * bf2f(w[n]));
    }
  }
}

// The row phases of the tensor-core build, spread over the grid in two
// passes with a grid barrier between them (one block a row leaves all but M
// blocks idle while it adds each element's partials). rows_sum: for each
// row m and 128-column chunk c (an item), v = base + the `splits` partials in
// order, yf = v (f32), out = bf16(v) when given, and the chunk's sum of v^2
// into ssp[m][c]. base is x (bf16) or, with x_base null, yf itself (written
// by another block before the barrier: read through L2).
template <int T>
__device__ void rows_sum(const float* part, int splits, int M, int N,
                         const __nv_bfloat16* x_base, float* yf, __nv_bfloat16* out,
                         float* ssp) {
  __shared__ float red[T / 32];
  const size_t mn = (size_t)M * N;
  const int chunks = (N + T - 1) / T;
  for (int it = blockIdx.x; it < M * chunks; it += gridDim.x) {
    const int m = it / chunks;
    const int n = (it - m * chunks) * T + threadIdx.x;
    float v = 0.f;
    if (n < N) {
      const size_t o = (size_t)m * N + n;
      float acc = 0.f;
#pragma unroll 8
      for (int z = 0; z < splits; ++z) acc += __ldcg(part + z * mn + o);
      v = (x_base != nullptr ? bf2f(x_base[o]) : __ldcg(yf + o)) + acc;
      yf[o] = v;
      if (out != nullptr) out[o] = __float2bfloat16(v);
    }
    const float ss = block_sum<T>(v * v, red);
    if (threadIdx.x == 0) ssp[it] = ss;
  }
}

// rows_norm: h = bf16(yf * rsqrt(mean(yf^2) + eps) * w) for every element,
// each row's sum of squares its chunks' sums (a warp's fixed tree).
template <int T>
__device__ void rows_norm(int M, int N, const float* yf, const float* ssp,
                          const __nv_bfloat16* w, __nv_bfloat16* h, float eps) {
  __shared__ float inv[32];  // M <= 32
  const int chunks = (N + T - 1) / T;
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < M; m += T / 32) {
    float ss = 0.f;
    for (int c = lane; c < chunks; c += 32) ss += __ldcg(ssp + m * chunks + c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv[m] = 1.0f / sqrtf(ss / (float)N + eps);
  }
  __syncthreads();
  const size_t mn = (size_t)M * N;
  for (size_t o = blockIdx.x * (size_t)T + threadIdx.x; o < mn; o += (size_t)gridDim.x * T) {
    const int m = (int)(o / N);
    h[o] = __float2bfloat16(__ldcg(yf + o) * inv[m] * bf2f(w[o - (size_t)m * N]));
  }
}

// A row phase of the kernel's build: dq_tile's build keeps its first
// version, one block a row.
template <int T, bool TC>
__device__ __forceinline__ void rows(cg::grid_group& grid, const float* part, int splits, int M,
                                     int N, const __nv_bfloat16* x_base, float* yf,
                                     __nv_bfloat16* out, const __nv_bfloat16* w,
                                     __nv_bfloat16* h, float* ssp, float eps) {
  if constexpr (TC) {
    rows_sum<T>(part, splits, M, N, x_base, yf, out, ssp);
    grid.sync();
    rows_norm<T>(M, N, yf, ssp, w, h, eps);
  } else {
    row_phase<T>(part, splits, M, N, x_base, yf, out, w, h, eps);
  }
}

// One matmul phase on the tiles of the kernel's build.
template <int BITS, bool TC>
__device__ __forceinline__ void matmul_phase(const DqArgs& a, int splits, uint8_t* base) {
  if constexpr (TC) run_tc_tiles<BITS>(a, splits, base);
  else run_tiles<BITS>(a, splits);
}

template <int BITS, bool TC>
__global__ void __launch_bounds__(Lb<TC>::kThreads, Lb<TC>::kMinBlocks)
    boundary_kernel(LbArgs p) {
  constexpr int T = Lb<TC>::kThreads;
  extern __shared__ uint8_t lb_smem[];  // the tensor-core tiles' (dq_tile names its own)
  uint8_t* base = lb_smem + ((16 - (gtc_smem_u32(lb_smem) & 15)) & 15);
  cg::grid_group grid = cg::this_grid();
  const int M = p.o.M, D = p.o.N;
  matmul_phase<BITS, TC>(p.o, p.splits_o, base);
  grid.sync();
  rows<T, TC>(grid, p.o.part, p.splits_o, M, D, p.x, p.y, nullptr, p.mn,
              const_cast<__nv_bfloat16*>(p.gu.x), p.ssp, p.eps);
  grid.sync();
  matmul_phase<BITS, TC>(p.gu, p.splits_gu, base);
  grid.sync();
  {  // act = bf16(silu(gate)) * bf16(up), gate columns [0, F), up [F, 2F)
    const int F = p.d.K;
    const size_t mf = (size_t)M * F, m2f = 2 * mf;
    __nv_bfloat16* act = const_cast<__nv_bfloat16*>(p.d.x);
    for (size_t i = blockIdx.x * (size_t)T + threadIdx.x; i < mf; i += (size_t)gridDim.x * T) {
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
  matmul_phase<BITS, TC>(p.d, p.splits_d, base);
  grid.sync();
  rows<T, TC>(grid, p.d.part, p.splits_d, M, D, nullptr, p.y, p.y2, p.an,
              const_cast<__nv_bfloat16*>(p.q.x), p.ssp, p.eps);
  grid.sync();
  matmul_phase<BITS, TC>(p.q, p.splits_q, base);
  if (p.splits_q > 1) {
    grid.sync();
    const size_t mn = (size_t)M * p.q.N;
    for (size_t o = blockIdx.x * (size_t)T + threadIdx.x; o < mn; o += (size_t)gridDim.x * T) {
      float acc = 0.f;
      for (int z = 0; z < p.splits_q; ++z) acc += __ldcg(p.q.part + z * mn + o);
      p.q.out[o] = __float2bfloat16(acc);
    }
  }
}

template <int BITS, bool TC>
size_t smem_bytes(int group) {
  if constexpr (TC) return TcLayout<BITS, 0>::smem(kTcSlice);
  else return dq_smem_bytes<BITS, kTM, kCQ, 0>(group);
}

// Blocks of the cooperative grid: as many as can be resident at once.
template <int BITS, bool TC>
int grid_blocks(int group) {
  const size_t smem = smem_bytes<BITS, TC>(group);
  if (smem > 227 * 1024) return -1;
  cudaError_t e = cudaFuncSetAttribute(boundary_kernel<BITS, TC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boundary_kernel<BITS, TC>,
                                                    Lb<TC>::kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return -(int)e;
  return per_sm * sms;  // 0 when not one block fits: the caller raises
}

template <int BITS, bool TC>
int launch(LbArgs p, int blocks, cudaStream_t st) {
  const size_t smem = smem_bytes<BITS, TC>(p.o.group);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)boundary_kernel<BITS, TC>, dim3(blocks),
                                              dim3(Lb<TC>::kThreads), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The rule of the tensor-core tiles, on every phase's matmul: W4 or W8, group
// 64 or 128, N a multiple of 16 (16-byte loads of 16 columns), the codes,
// scales, zeros and x 16-byte aligned (cp.async), and slices of at most
// kTcSlice K values. Mirrored by boundary_route (and _slices' cap) in
// qtpu_torch/kernels/layer_boundary.py.
bool lb_tc_fits(const LbArgs& p, int bits) {
  auto al = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (bits != 4 && bits != 8) return false;
  const DqArgs* phases[] = {&p.o, &p.gu, &p.d, &p.q};
  for (const DqArgs* a : phases) {
    if ((a->group != 64 && a->group != 128) || a->N % 16 != 0 || a->ldw % 16 != 0 ||
        a->split_groups * a->group > kTcSlice || !al(a->x) || !al(a->data) ||
        !al(a->scales) || !al(a->zeros))
      return false;
  }
  return true;
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

// The cooperative grid of K13 for this packing and build (tc: the
// tensor-core tiles, else dq_tile's): blocks resident at once on the current
// device, 0 when none fits, or a negative error.
extern "C" int qtpu_layer_boundary_grid(int bits, int group, int tc) {
  if (group <= 0 || group % 4 != 0) return -1;
  switch (bits * 2 + (tc != 0)) {
    case 8: return grid_blocks<4, false>(group);
    case 9: return grid_blocks<4, true>(group);
    case 16: return grid_blocks<8, false>(group);
    case 17: return grid_blocks<8, true>(group);
    default: return -1;
  }
}

// attn [M, Q], x [M, D], mn/an [D] bf16; o [Q/PK, D], gu [D/PK, 2F], d [F/PK,
// D], q [D/PK, Nq] packed with bf16 scales and uint8 zeros [K/g, N]; outputs
// y2 [M, D], qkv [M, Nq] bf16. Scratch: y [M, D] f32 followed by
// [M, ceil(D / 128)] f32 (the row sums of the tensor-core build); h, h2 [M, D] and act
// [M, F] bf16; part_o [so, M, D], part_gu [sgu, M, 2F], part_d [sd, M, D],
// part_q [sq, M, Nq] f32 (null for sq = 1), the slices so = ceil(Q/g /
// per_o) and so on. tc: the tensor-core tiles (lb_tc_fits must hold), else
// dq_tile's; blocks: qtpu_layer_boundary_grid's count for the same build or
// fewer. Returns a cudaError_t (0 on success), or -1 for arguments the kernel
// does not take.
extern "C" int qtpu_layer_boundary(
    const void* attn, const void* x, const void* mn, const void* an,
    const void* o_data, const void* o_scales, const void* o_zeros,
    const void* gu_data, const void* gu_scales, const void* gu_zeros,
    const void* d_data, const void* d_scales, const void* d_zeros,
    const void* q_data, const void* q_scales, const void* q_zeros,
    void* y2, void* qkv, void* y, void* h, void* act, void* h2,
    void* part_o, void* part_gu, void* part_d, void* part_q,
    int per_o, int per_gu, int per_d, int per_q, int tc, int blocks,
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
  p.ssp = p.y + (size_t)M * D;
  p.y2 = static_cast<__nv_bfloat16*>(y2);
  p.splits_o = so;
  p.splits_gu = sgu;
  p.splits_d = sd;
  p.splits_q = sq;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc != 0 && !lb_tc_fits(p, bits)) return -1;
  switch (bits * 2 + (tc != 0)) {
    case 8: return launch<4, false>(p, blocks, st);
    case 9: return launch<4, true>(p, blocks, st);
    case 16: return launch<8, false>(p, blocks, st);
    case 17: return launch<8, true>(p, blocks, st);
    default: return -1;
  }
}
