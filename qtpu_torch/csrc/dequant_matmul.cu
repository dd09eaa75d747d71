// K1: fused dequantize + matmul for packed W2/W4/W8 weights.
//
// Replaces the TPU kernels pallas_quantized_matmul_stacked
// (qtpu/kernels/pallas_dequant_matmul.py:385) and pallas_quantized_matmul
// (:502). On the GPU a layer of a stacked [L, Kp, N] weight is a zero-copy
// view, so one kernel serves both entry points.
//
// Bound on an H100: at decode (M = 8) the packed weight bytes (W4: K*N/2
// plus the group scales and zeros); at prefill (M = 1024) the multiply-adds.
// What the design does about it, by the M it is given:
//  * M <= 8, W4/W8, g 64 or 128, N % 16 == 0 and the codes, scales and zeros
//    16-byte aligned (gemv_tc_fits, with the wrapper's split of K over a
//    thread-block cluster): the tensor-core GEMV of dq_gemv_tc.cuh (its note
//    gives the design), one launch a call;
//  * other M <= 8 calls (W2, other groups, ragged N, unaligned tensors): the
//    weight-streaming GEMV of dq_core.cuh (each weight byte read once,
//    dequantized in registers, K split across lanes and blocks so enough
//    loads are in flight for the narrow decode shapes);
//  * M > 8, g 64 or 128, N % 16 == 0 and x, codes, scales and zeros 16-byte
//    aligned (wgmma_fits): dq_wgmma_kernel of dq_wgmma.cuh, wgmma fed by TMA
//    through mbarriers (its note gives the design). Its weight operand is
//    the integer code minus the zero point, exact in bf16, so no weight is
//    rounded; each group's f32 sum is scaled by the group's scale before it
//    joins the accumulator, the per-group f32 correction the TPU kernel
//    applies to its output tile;
//  * other M > 8 calls (ragged N, other groups, an unaligned weight):
//    dq_mma_kernel of dq_mma.cuh, the same arithmetic on mma.sync m16n8k16
//    with synchronous loads. It needs g / PK packed rows per group to be a
//    multiple of 16 (W4: g a multiple of 32); other groups take the GEMV
//    path tiled over M.
// The options of the TPU kernel (pallas_dequant_matmul.py:385-470): norm_w,
// x normalized in the launch (rms in f32 over all of K) and resid, added to
// the f32 sums in the epilogue and cast once. At M <= 8 they run in the
// tensor-core GEMV where it takes the call (MODE 4, 2 and 6 of
// dq_gemv_tc.cuh), else in dq_core's GEMV (split K as above; the norm a
// prologue, rounded to bf16 as the TPU kernel rounds it). At M > 8 they run
// on the Hopper route (dq_wgmma.cuh's OPT instances: the norm's row factor
// in the epilogue, nw folded into each landed x tile; its note gives the
// design) for the calls wgmma_fits takes, at any M; the mma.sync body takes
// none (the wrapper's options_supported says so from the shape and the
// caller composes). Each is its own template instance, so the plain builds
// compile as before.
// Ragged M and N edges are masked in the kernels, so no caller pads; at
// N % 4 != 0 (GPT-2's lm_head, N 50257) the packed rows are unaligned and
// a separate build of both kernels (VEC = false) reads each thread's 4
// columns byte by byte; aligned shapes run the vector-load build (qtpu
// sends ragged shapes to XLA, qtpu/kernels/dequant_matmul.py:64).
#include "dq_gemv_tc.cuh"
#include "dq_mma.cuh"
#include "dq_wgmma.cuh"

using namespace qtpu;

namespace {

template <int BITS, bool VEC>
int dq_dispatch(const DqArgs& a, cudaStream_t st) {
  constexpr int PK = 8 / BITS;
  if (a.M <= 8 || (a.group / PK) % kMmaRows != 0) return launch_dq<BITS, 8, 8, 0, VEC>(a, st);
  if (a.split_groups != a.K / a.group) return -1;  // the mma path does not split K
  return launch_dq_mma<BITS, false, VEC>(a, st);
}

template <int BITS>
int dq_dispatch(const DqArgs& a, cudaStream_t st) {
  if (wgmma_fits(a)) return launch_dq_wgmma<BITS, false>(a, st);
  return a.N % 4 == 0 ? dq_dispatch<BITS, true>(a, st) : dq_dispatch<BITS, false>(a, st);
}

template <int BITS>
int dq_option_dispatch(const DqArgs& a, cudaStream_t st) {
  if (a.nw == nullptr) return launch_dq<BITS, 8, 8, 2>(a, st);
  if (a.resid == nullptr) return launch_dq<BITS, 8, 8, 4>(a, st);
  return launch_dq<BITS, 8, 8, 6>(a, st);
}

DqArgs make_args(const void* x, const void* data, const void* scales, const void* zeros,
                 void* out, void* part, int split_groups, int M, int K, int N, int group) {
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
}  // namespace

// y[M, N] = x[M, K] @ dequant(data, scales, zeros); x must be 16-byte
// aligned. split_groups: groups of K per block slice, K / group for no split;
// with more than one slice (M <= 8 only), `part` is an f32 scratch of
// slices * M * N. cluster > 0 (M <= 8): the tensor-core GEMV with K split
// into `cluster` slices of split_groups groups (part unused); -1 where
// gemv_tc_fits refuses the call. cluster 0: the other bodies (dq_core's GEMV
// at M <= 8). Returns a cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int qtpu_dq_matmul(const void* x, const void* data, const void* scales,
                              const void* zeros, void* out, void* part, int split_groups,
                              int cluster, int M, int K, int N, int bits, int group,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group <= 0 || group % 4 != 0 ||
      K % group != 0)
    return -1;
  const DqArgs a = make_args(x, data, scales, zeros, out, part, split_groups, M, K, N, group);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) return gemv_tc<0>(a, bits, cluster, split_groups, st);
  switch (bits) {
    case 2: return dq_dispatch<2>(a, st);
    case 4: return dq_dispatch<4>(a, st);
    case 8: return dq_dispatch<8>(a, st);
    default: return -1;
  }
}

// qtpu_dq_matmul with the options: y = [resid +] (norm_w ? rms_norm(x) *
// norm_w : x) @ dequant(...), nw [K] and resid [M, N] bf16 (either may be
// null, not both); N % 4 == 0, nw 8-byte aligned, resid 4-byte aligned.
// cluster as in qtpu_dq_matmul (the tensor-core GEMV's MODE 2, 4 or 6 at
// M <= 8); M > 8 takes the Hopper route only (split_groups K / group), -1
// where wgmma_fits refuses the call.
extern "C" int qtpu_dq_matmul_opt(const void* x, const void* data, const void* scales,
                                  const void* zeros, const void* nw, const void* resid,
                                  void* out, void* part, int split_groups, int cluster, int M,
                                  int K, int N, int bits, int group, float eps, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || group <= 0 || group % 4 != 0 ||
      K % group != 0 || (nw == nullptr && resid == nullptr))
    return -1;
  DqArgs a = make_args(x, data, scales, zeros, out, part, split_groups, M, K, N, group);
  a.nw = static_cast<const __nv_bfloat16*>(nw);
  a.resid = static_cast<const __nv_bfloat16*>(resid);
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    if (nw == nullptr) return gemv_tc<2>(a, bits, cluster, split_groups, st);
    if (resid == nullptr) return gemv_tc<4>(a, bits, cluster, split_groups, st);
    return gemv_tc<6>(a, bits, cluster, split_groups, st);
  }
  if (M > 8) {
    if (!wgmma_fits(a)) return -1;
    switch (bits) {
      case 2: return launch_dq_wgmma<2, false, true>(a, st);
      case 4: return launch_dq_wgmma<4, false, true>(a, st);
      case 8: return launch_dq_wgmma<8, false, true>(a, st);
      default: return -1;
    }
  }
  switch (bits) {
    case 2: return dq_option_dispatch<2>(a, st);
    case 4: return dq_option_dispatch<4>(a, st);
    case 8: return dq_option_dispatch<8>(a, st);
    default: return -1;
  }
}

// Host nanoseconds to encode the two tensor maps of one wgmma-route call of
// qtpu_dq_matmul at W4 g128 (x [M, K], data [K / 2, N]), the mean over reps
// encodes; -1 where the driver has no encoder or the shape is refused.
extern "C" long long qtpu_dq_map_ns(const void* x, const void* data, int M, int K, int N,
                                    int reps) {
  const DqArgs a = make_args(x, data, nullptr, nullptr, nullptr, nullptr, K / 128, M, K, N, 128);
  return wgmma_map_ns<4>(a, reps);
}
