// K9 and K10: packed expert matmuls of a sparse-MoE layer.
//
// K9 (qtpu_moe_grouped) replaces pallas_moe_quantized_matmul
// (qtpu/kernels/pallas_moe_matmul.py:40): every expert of one layer's site
// in one launch, out[e] = x @ dequant(W[e]) with x [M, K] shared by the
// experts or x[e] of an [E, M, K] per-expert input, into [E, M, N].
// K10 (qtpu_moe_gathered) replaces pallas_moe_gathered_matmul (:165): one
// routed slot per row, out[i] = x[i] @ dequant(W[eidx[i]]) into [Gs, N], the
// expert index read from device memory by the blocks that need it (no host
// synchronization).
//
// Weights are one layer's view [E, K / PK, N] of the stacked [L, E, ...]
// leaf, scales and zeros [E, K / g, N], in K1's layout (dq_core.cuh).
// Bound on an H100: at decode the packed bytes of the experts streamed (K9:
// all E; K10: the distinct routed ones); at prefill (M = 1024) the
// multiply-adds.
// Design: K1's kernels with an expert axis.
//  * K10 where gathered_tc_fits holds (K1's gemv_tc_fits on one slot's view,
//    the expert strides 16-byte aligned; the wrapper passes the cluster):
//    the tensor-core GEMV's block body (dq_gemv_tc.cuh's gtc_block), one
//    weight stream per distinct routed expert. The grid is (cluster x
//    column strips, Gs); the block of slot i counts the earlier slots of
//    its expert (warp 0, ballots over eidx) and leads only when that count
//    is a multiple of 8: it then takes itself and the next at most 7 slots
//    of the expert as the 8 columns of the mma's B operand, staging their x
//    rows through a row map and writing each output row to its own slot.
//    Every block of another slot leaves at once, before any barrier; a
//    cluster shares blockIdx.y, so its blocks all leave or all stay. K is
//    split over the cluster and merged through DSMEM as for K1: one launch,
//    no scratch. At Mixtral's 2-slot step (4 slots, 3 distinct experts) it
//    streams each routed expert's bytes once;
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
//    slices + slice) or from eidx[row] (K10, one slot per row tile: a
//    repeated expert streams once per slot; qtpu_moe_gathered with cluster
//    0 keeps this body for the "was" times), moves
//    the pointers of x, the weight, the scales and zeros, the output and the
//    split-K scratch by that expert's strides, and runs K1's body on them:
//    the split-K weight-streaming GEMV of dq_core.cuh at the other M <= 8
//    calls (and for every K10 slot), the mma.sync tensor-core body of
//    dq_mma.cuh for the other M > 8 calls. qtpu_moe_grouped_mma runs that mma.sync body on any
//    M > 8 call, the route's earlier body kept for comparison on the same
//    bytes; no serving or eval path calls it.
// Indices outside [0, E) leave their rows unwritten (dq_core's K10 body with
// split K: its finishing pass writes them from partials no block wrote).
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
using qtpu::gtc_block;
using qtpu::gtc_smem_u32;
using qtpu::gtc_sums;
using qtpu::kTcCols;
using qtpu::kTcMaxCluster;
using qtpu::launch_gemv_tc;
using qtpu::launch_moe_wgmma;
using qtpu::launch_tc_cluster;
using qtpu::TcLayout;
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

// K10's plan, by warp 0 of slot i's block: the slot's expert e = eidx[i]
// (lead[0]) and how many slots its block takes (lead[1]; 0: none). The block
// leads when e is in [0, E) and the slots j < i of expert e number a multiple
// of 8; it then takes the first at most 8 slots j >= i of e, in order, into
// rows. So every slot in range is taken by exactly one leader, which takes
// at most 8 (a numpy model of it: tests/test_torch_route_gathered.py).
__device__ __forceinline__ void gathered_plan(const int* eidx, int i, int Gs, int E, int* rows,
                                              int* lead) {
  const int lane = threadIdx.x & 31;
  const int e = eidx[i];
  int n = 0;
  if (e >= 0 && e < E) {
    int before = 0;
    for (int j0 = 0; j0 < i; j0 += 32) {
      const int j = j0 + lane;
      before += __popc(__ballot_sync(0xffffffffu, j < i && eidx[j] == e));
    }
    if (before % 8 == 0) {
      for (int j0 = i; j0 < Gs && n < 8; j0 += 32) {
        const int j = j0 + lane;
        const unsigned hit = __ballot_sync(0xffffffffu, j < Gs && eidx[j] == e);
        const int r = n + __popc(hit & ((1u << lane) - 1u));
        if (((hit >> lane) & 1u) && r < 8) rows[r] = j;
        n += __popc(hit);
      }
      n = min(n, 8);
    }
  }
  if (lane == 0) {
    lead[0] = e;
    lead[1] = n;
  }
}

// K10's cluster epilogue, after the cluster.sync that follows every block's
// gtc_block: dq_gemv_tc_kernel's merge (block `rank` of the C blocks adds the
// C blocks' sums, read through distributed shared memory, of its 1/C of the
// strip's outputs) with row m written to output row rows[m]. A copy, not a
// shared helper: factoring it out of dq_gemv_tc_kernel changed the SASS of
// K1's, K4's and K7's instances.
__device__ __forceinline__ void gathered_merge(const DqArgs& a,
                                               cooperative_groups::cluster_group& cluster,
                                               int rank, int csize, int n0, float* sums,
                                               const int* rows) {
  const int tid = threadIdx.x;
  const int share = (1024 + csize - 1) / csize;
  const int oend = min(1024, (rank + 1) * share);
  for (int o = rank * share + tid; tid < 128 && o < oend; o += 128) {
    float part[kTcMaxCluster];  // the blocks' sums, loaded together
#pragma unroll
    for (int z = 0; z < kTcMaxCluster; ++z)
      part[z] = z < csize ? cluster.map_shared_rank(sums, z)[o] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int z = 0; z < kTcMaxCluster; ++z) sum += part[z];
    // o = (i * 4 + e) * 32 + lane of the warps' layout: column 16 (lane / 4) + 2 i + e / 2,
    // row 2 (lane % 4) + e % 2
    const int ln = o & 31;
    const int i = o >> 7;
    const int e = (o >> 5) & 3;
    const int n = n0 + 16 * (ln >> 2) + 2 * i + (e >> 1);
    const int r = 2 * (ln & 3) + (e & 1);
    if (r < a.M && n < a.N) a.out[(size_t)rows[r] * a.N + n] = __float2bfloat16(sum);
  }
}

// K10 on the tensor-core GEMV: grid (cluster x column strips, Gs), cluster
// (cluster, 1, 1), block TcLayout<BITS, 0>::THREADS; a.M = Gs.
template <int BITS>
__global__ void __launch_bounds__(TcLayout<BITS, 0>::THREADS, 512 / TcLayout<BITS, 0>::THREADS)
    moe_gathered_tc_kernel(DqArgs a, TcArgs t, const int* __restrict__ eidx) {
  namespace cg = cooperative_groups;
  __shared__ int rows[8];  // the slots the block takes (row map of x and out)
  __shared__ int lead[2];  // its expert, how many slots
  extern __shared__ uint8_t gtc_smem[];  // aligned to 16 by hand, as in dq_gemv_tc_kernel
  uint8_t* base = gtc_smem + ((16 - (gtc_smem_u32(gtc_smem) & 15)) & 15);

  if (threadIdx.x < 32) gathered_plan(eidx, blockIdx.y, a.M, t.E, rows, lead);
  __syncthreads();
  if (lead[1] == 0) return;  // the whole cluster (one slot) leaves, before any barrier
  const int e = lead[0];
  a.data += (size_t)e * t.w_es;
  a.scales += (size_t)e * t.s_es;
  if (a.zeros != nullptr) a.zeros += (size_t)e * t.s_es;
  a.M = lead[1];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / t.cluster) * kTcCols;
  const int groups = a.K / a.group;
  const int gb = rank * t.slice_groups;
  const int ge = min(groups, gb + t.slice_groups);
  const int ksl = ge > gb ? (ge - gb) * a.group : 0;
  gtc_block<BITS, 0, true>(a, n0, gb * a.group, ksl, t.slice_groups * a.group + 8, base, rows);
  cluster.sync();  // every block's sums are in its shared memory
  gathered_merge(a, cluster, rank, t.cluster, n0, gtc_sums<BITS, 0>(base), rows);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// K10's rule: K1's gemv_tc_fits on one slot's view (a leader takes at most 8
// rows; x's rows are K * 2 bytes apart, a multiple of 16 at group 64 or 128),
// Gs within the grid's y, and every stride between two experts (codes,
// scales, zeros) a multiple of 16 bytes. Mirrored by gathered_route in
// qtpu_torch/kernels/moe_matmul.py.
bool gathered_tc_fits(const DqArgs& a, const MoeArgs& m, int bits, int cluster,
                      int slice_groups) {
  DqArgs one = a;
  one.M = 1;
  return a.M >= 1 && a.M <= 65535 && gemv_tc_fits(one, bits, cluster, slice_groups) &&
         m.w_es % 16 == 0 && m.s_es * 2 % 16 == 0 && (a.zeros == nullptr || m.s_es % 16 == 0);
}

template <int BITS>
int gathered_tc(const DqArgs& a, const MoeArgs& m, int cluster, cudaStream_t st) {
  if (!gathered_tc_fits(a, m, BITS, cluster, a.split_groups)) return -1;
  const TcArgs t{m.E, cluster, a.split_groups, 0, m.w_es, m.s_es, 0};
  static bool smem_set = false;
  return launch_tc_cluster<BITS, 0>(moe_gathered_tc_kernel<BITS>, smem_set, a, t, a.M, st,
                                    m.eidx);
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

// K10. x [Gs, K] bf16 (16-byte aligned); eidx [Gs] int32 on the device;
// data, scales, zeros as for K9; out [Gs, N] bf16. cluster > 0 (W4/W8): the
// tensor-core GEMV, K split into `cluster` slices of split_groups groups
// (part unused), -1 where gathered_tc_fits refuses the call. cluster 0:
// dq_core's GEMV, one slot a row tile, split_groups / part as for K9, part
// holding slices * Gs * N floats.
extern "C" int qtpu_moe_gathered(const void* x, const void* eidx, const void* data,
                                 const void* scales, const void* zeros, void* out, void* part,
                                 int split_groups, int cluster, int E, int Gs, int K, int N,
                                 int bits, int group, void* stream) {
  if (bad_shape(E, Gs, K, N, group) || eidx == nullptr) return -1;
  const DqArgs a = dq_args(x, data, scales, zeros, out, part, split_groups, Gs, K, N, group);
  const MoeArgs m = moe_args(eidx, E, 0, bits, Gs, K, N, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (bits == 4) return gathered_tc<4>(a, m, cluster, st);
    if (bits == 8) return gathered_tc<8>(a, m, cluster, st);
    return -1;
  }
  switch (bits) {
    case 2: return launch_gemv<2, 1>(a, m, st);
    case 4: return launch_gemv<4, 1>(a, m, st);
    case 8: return launch_gemv<8, 1>(a, m, st);
    default: return -1;
  }
}
