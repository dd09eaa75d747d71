// K9 and K10: packed expert matmuls of a sparse-MoE layer.
//
// K9 (qtpu_moe_grouped) replaces pallas_moe_quantized_matmul
// (qtpu/kernels/pallas_moe_matmul.py:40): every expert of one layer's site
// in one launch, out[e] = x @ dequant(W[e]) with x [M, K] shared by the
// experts or x[e] of an [E, M, K] per-expert input, into [E, M, N].
// K10 (qtpu_moe_gathered) replaces pallas_moe_gathered_matmul (:165): one
// routed slot per row, out[i] = x[i] @ dequant(W[eidx[i]]) into [Gs, N], the
// expert index read from device memory by the block that needs it (no host
// synchronization; a repeated expert streams once per slot, and L2 absorbs
// the repeat).
//
// Weights are one layer's view [E, K / PK, N] of the stacked [L, E, ...]
// leaf, scales and zeros [E, K / g, N], in K1's layout (dq_core.cuh).
// Bound on an H100: at decode the packed bytes of the experts streamed (K9:
// all E; K10: the routed ones); at prefill (M = 1024) the multiply-adds.
// Design: K1's kernels with an expert axis.
//  * K9 at M <= 8 where moe_gemv_tc_fits holds (K1's gemv_tc_fits on the
//    first expert's view, and every stride between experts 16-byte aligned;
//    the wrapper passes the cluster): the tensor-core GEMV of dq_gemv_tc.cuh
//    with its expert axis (blockIdx.y), one launch over every expert's
//    column strips and K slices;
//  * K9 at M > 8 where moe_wgmma_fits holds (K1's wgmma_fits on the first
//    expert's view, and every stride between experts 16-byte aligned): the
//    Hopper route of dq_wgmma.cuh with its expert axis (EXPERTS), one
//    persistent launch over every expert's 128 x 128 tiles, wgmma fed by
//    TMA (that file's note gives the design);
//  * otherwise a block finds its expert from blockIdx.z (K9: expert * K
//    slices + slice) or from eidx[row] (K10, one slot per row tile), moves
//    the pointers of x, the weight, the scales and zeros, the output and the
//    split-K scratch by that expert's strides, and runs K1's body on them:
//    the split-K weight-streaming GEMV of dq_core.cuh at the other M <= 8
//    calls (and for every K10 slot), the mma.sync tensor-core body of
//    dq_mma.cuh for the other M > 8 calls. qtpu_moe_grouped_mma runs that mma.sync body on any
//    M > 8 call, the route's earlier body kept for comparison on the same
//    bytes; no serving or eval path calls it.
// Indices outside [0, E) leave their rows unwritten.
#include "dq_gemv_tc.cuh"
#include "dq_mma.cuh"
#include "dq_wgmma.cuh"

// Using-declarations, not `using namespace qtpu`: the route's helpers live in
// an anonymous namespace inside qtpu, which would make this file's own
// anonymous namespace (its kernels) ambiguous in nvcc's launch stubs.
using qtpu::DqArgs;
using qtpu::dq_body;
using qtpu::dq_mma_body;
using qtpu::dq_smem_bytes;
using qtpu::kMmaBM;
using qtpu::kMmaBN;
using qtpu::kMmaRows;
using qtpu::kThreads;
using qtpu::gemv_tc_fits;
using qtpu::launch_gemv_tc;
using qtpu::launch_moe_wgmma;
using qtpu::TcArgs;
using qtpu::wgmma_fits;

namespace {

struct MoeArgs {
  const int* eidx;  // K10: expert of each row [Gs], else nullptr (K9)
  int E;
  int splits;       // K slices per expert (K9) or per row (K10)
  long long x_es;   // elements between experts' inputs (0: shared input)
  long long w_es;   // bytes between experts' packed weights
  long long s_es;   // elements between experts' scales (and zeros)
  long long o_es;   // elements between experts' outputs
  long long p_es;   // floats between experts' split-K partial sums
};

// The expert of this block and its K slice, with a's pointers moved to it.
// Returns false for an expert index outside [0, E).
__device__ __forceinline__ bool expert_view(DqArgs& a, const MoeArgs& m, int& zs) {
  int e;
  if (m.eidx != nullptr) {
    e = m.eidx[blockIdx.y];
    zs = blockIdx.z;
  } else {
    e = blockIdx.z / m.splits;
    zs = blockIdx.z - e * m.splits;
  }
  if (e < 0 || e >= m.E) return false;
  a.x += (size_t)e * m.x_es;
  a.data += (size_t)e * m.w_es;
  a.scales += (size_t)e * m.s_es;
  if (a.zeros != nullptr) a.zeros += (size_t)e * m.s_es;
  a.out += (size_t)e * m.o_es;
  if (a.part != nullptr) a.part += (size_t)e * m.p_es;
  return true;
}

template <int BITS, int TM>
__global__ void __launch_bounds__(kThreads) moe_gemv_kernel(DqArgs a, MoeArgs m) {
  DqArgs b = a;
  int zs;
  if (!expert_view(b, m, zs)) return;
  dq_body<BITS, TM, 8, 0>(b, zs);
}

template <int BITS>
__global__ void __launch_bounds__(kThreads) moe_mma_kernel(DqArgs a, MoeArgs m) {
  DqArgs b = a;
  int zs;
  if (!expert_view(b, m, zs)) return;
  dq_mma_body<BITS, false>(b);
}

// Sums the split-K partials, [experts][splits][M * N] floats, into out
// [experts][M * N] bf16.
__global__ void __launch_bounds__(kThreads) moe_finish(const float* part, __nv_bfloat16* out,
                                                       size_t mn, int experts, int splits) {
  const size_t total = mn * experts;
  for (size_t o = blockIdx.x * (size_t)kThreads + threadIdx.x; o < total;
       o += (size_t)gridDim.x * kThreads) {
    const size_t e = o / mn;
    const size_t r = o - e * mn;
    float sum = 0.f;
    for (int z = 0; z < splits; ++z) sum += part[(e * splits + z) * mn + r];
    out[o] = __float2bfloat16(sum);
  }
}

// The GEMV path: grid (N / 32, row tiles, experts * slices) for K9, (N / 32,
// Gs, slices) for K10 (TM = 1: one slot per row tile).
template <int BITS, int TM>
int launch_gemv(DqArgs a, MoeArgs m, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = dq_smem_bytes<BITS, TM, 8, 0>(a.group);
  const int groups = a.K / a.group;
  if (smem > 227 * 1024 || a.split_groups < 1 || a.split_groups > groups) return -1;
  const int splits = (groups + a.split_groups - 1) / a.split_groups;
  if (splits == 1) a.part = nullptr;
  else if (a.part == nullptr) return -1;
  const bool gathered = m.eidx != nullptr;
  m.splits = splits;
  m.p_es = gathered ? 0 : (long long)splits * a.M * a.N;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(moe_gemv_kernel<BITS, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((a.N + 31) / 32, (a.M + TM - 1) / TM, gathered ? splits : m.E * splits);
  moe_gemv_kernel<BITS, TM><<<grid, kThreads, smem, st>>>(a, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t mn = (size_t)a.M * a.N;
  const int experts = gathered ? 1 : m.E;
  const size_t total = mn * experts;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 1024 ? (total + kThreads - 1) / kThreads
                                                                    : 1024);
  moe_finish<<<blocks, kThreads, 0, st>>>(a.part, a.out, mn, experts, splits);
  return (int)cudaGetLastError();
}

// The mma.sync body on every expert: grid (N / 64, M / 128, E).
template <int BITS>
int grouped_mma(const DqArgs& a, MoeArgs m, cudaStream_t st) {
  if (a.split_groups != a.K / a.group) return -1;  // the mma path does not split K
  dim3 grid((a.N + kMmaBN - 1) / kMmaBN, (a.M + kMmaBM - 1) / kMmaBM, m.E);
  m.splits = 1;
  moe_mma_kernel<BITS><<<grid, kThreads, 0, st>>>(a, m);
  return (int)cudaGetLastError();
}

// K9's route rule: K1's wgmma_fits on the first expert's view, and every
// stride between two experts (x when each has its own, the codes, scales,
// zeros and output) a multiple of 16 bytes, so each expert's rows start
// where TMA and the bulk copies read them. N % 16 == 0 and K % g == 0 imply
// the strides' alignment; the rule checks it all the same. Mirrored by
// moe_route in qtpu_torch/kernels/moe_matmul.py.
bool moe_wgmma_fits(const DqArgs& a, const MoeArgs& m) {
  return wgmma_fits(a) && m.x_es * 2 % 16 == 0 && m.w_es % 16 == 0 && m.s_es * 2 % 16 == 0 &&
         (a.zeros == nullptr || m.s_es % 16 == 0) && m.o_es * 2 % 16 == 0;
}

// K9's rule at M <= 8: K1's gemv_tc_fits on the first expert's view and
// every stride between two experts a multiple of 16 bytes (8 for x, which
// is staged with 8-byte loads). Mirrored by moe_route / gemv_route.
bool moe_gemv_tc_fits(const DqArgs& a, const MoeArgs& m, int bits, int cluster,
                      int slice_groups) {
  return gemv_tc_fits(a, bits, cluster, slice_groups) && m.x_es * 2 % 8 == 0 &&
         m.w_es % 16 == 0 && m.s_es * 2 % 16 == 0 && (a.zeros == nullptr || m.s_es % 16 == 0);
}

template <int BITS>
int grouped_gemv_tc(const DqArgs& a, const MoeArgs& m, int cluster, cudaStream_t st) {
  if (!moe_gemv_tc_fits(a, m, BITS, cluster, a.split_groups)) return -1;
  const TcArgs t{m.E, cluster, a.split_groups, m.x_es, m.w_es, m.s_es, m.o_es};
  return launch_gemv_tc<BITS, 0, true>(a, t, st);
}

template <int BITS>
int grouped(const DqArgs& a, MoeArgs m, cudaStream_t st) {
  constexpr int PK = 8 / BITS;
  if (a.M <= 8 || (a.group / PK) % kMmaRows != 0) return launch_gemv<BITS, 8>(a, m, st);
  if (moe_wgmma_fits(a, m)) return launch_moe_wgmma<BITS>(a, m.E, m.x_es != 0 ? a.M : 0, st);
  return grouped_mma<BITS>(a, m, st);
}

DqArgs dq_args(const void* x, const void* data, const void* scales, const void* zeros, void* out,
               void* part, int split_groups, int M, int K, int N, int group) {
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
  return a;
}

bool bad_shape(int E, int M, int K, int N, int group) {
  return E <= 0 || M <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || group <= 0 || group % 4 != 0 ||
         K % group != 0;
}

MoeArgs moe_args(const void* eidx, int E, long long x_es, int bits, int M, int K, int N,
                 int group) {
  MoeArgs m{};
  m.eidx = static_cast<const int*>(eidx);
  m.E = E;
  m.splits = 1;
  m.x_es = x_es;
  m.w_es = (long long)K * bits / 8 * N;
  m.s_es = (long long)(K / group) * N;
  m.o_es = m.eidx != nullptr ? 0 : (long long)M * N;
  return m;
}

}  // namespace

// K9. x [M, K] (per_expert_input 0) or [E, M, K] bf16; data [E, K*bits/8, N]
// int8; scales [E, K/group, N] bf16; zeros the same in uint8 or nullptr
// (symmetric); out [E, M, N] bf16. split_groups: groups of K per slice (M <= 8
// only; K / group for none), `part` then an f32 scratch of E * slices * M * N.
// cluster > 0 (M <= 8, W4/W8): the tensor-core GEMV, K split into `cluster`
// slices of split_groups groups (part unused), -1 where its rule refuses the
// call. Returns a cudaError_t (0 on success), or -1 for arguments it does not
// take.
extern "C" int qtpu_moe_grouped(const void* x, const void* data, const void* scales,
                                const void* zeros, void* out, void* part, int split_groups,
                                int cluster, int per_expert_input, int E, int M, int K, int N,
                                int bits, int group, void* stream) {
  if (bad_shape(E, M, K, N, group)) return -1;
  const DqArgs a = dq_args(x, data, scales, zeros, out, part, split_groups, M, K, N, group);
  const MoeArgs m = moe_args(nullptr, E, per_expert_input ? (long long)M * K : 0, bits, M, K, N,
                             group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (bits == 4) return grouped_gemv_tc<4>(a, m, cluster, st);
    if (bits == 8) return grouped_gemv_tc<8>(a, m, cluster, st);
    return -1;
  }
  switch (bits) {
    case 2: return grouped<2>(a, m, st);
    case 4: return grouped<4>(a, m, st);
    case 8: return grouped<8>(a, m, st);
    default: return -1;
  }
}

// K9 on the mma.sync body at M > 8 (groups of a multiple of 16 packed rows),
// whatever the route rule says: the earlier body, kept so that the same bytes
// can be timed on both. Arguments as for qtpu_moe_grouped, without split K.
extern "C" int qtpu_moe_grouped_mma(const void* x, const void* data, const void* scales,
                                    const void* zeros, void* out, int per_expert_input, int E,
                                    int M, int K, int N, int bits, int group, void* stream) {
  if (bad_shape(E, M, K, N, group) || M <= 8 || group * bits / 8 % kMmaRows != 0) return -1;
  const DqArgs a = dq_args(x, data, scales, zeros, out, nullptr, K / group, M, K, N, group);
  const MoeArgs m = moe_args(nullptr, E, per_expert_input ? (long long)M * K : 0, bits, M, K, N,
                             group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return grouped_mma<2>(a, m, st);
    case 4: return grouped_mma<4>(a, m, st);
    case 8: return grouped_mma<8>(a, m, st);
    default: return -1;
  }
}

// K10. x [Gs, K] bf16; eidx [Gs] int32 on the device; data, scales, zeros as
// for K9; out [Gs, N] bf16. split_groups / part as for K9, part holding
// slices * Gs * N floats.
extern "C" int qtpu_moe_gathered(const void* x, const void* eidx, const void* data,
                                 const void* scales, const void* zeros, void* out, void* part,
                                 int split_groups, int E, int Gs, int K, int N, int bits,
                                 int group, void* stream) {
  if (bad_shape(E, Gs, K, N, group) || eidx == nullptr) return -1;
  const DqArgs a = dq_args(x, data, scales, zeros, out, part, split_groups, Gs, K, N, group);
  const MoeArgs m = moe_args(eidx, E, 0, bits, Gs, K, N, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch_gemv<2, 1>(a, m, st);
    case 4: return launch_gemv<4, 1>(a, m, st);
    case 8: return launch_gemv<8, 1>(a, m, st);
    default: return -1;
  }
}
