// K4: packed SwiGLU MLP block, y = x + (silu(h @ Wg) * (h @ Wu)) @ Wd with
// h = rms_norm(x) * nw, for decode shapes (M <= 32), asymmetric W4/W8; with
// resid = 0 the no-residual mode, y = (silu(h @ Wg) * (h @ Wu)) @ Wd (phase
// B as K1's plain MODE 0: a tensor-parallel rank whose partial sum is
// all-reduced, the residual added on one rank only).
//
// Replaces the TPU kernel pallas_fused_mlp_stacked
// (qtpu/kernels/pallas_fused_mlp.py:221) and its unstacked twin
// pallas_fused_mlp (:111). The TPU kernel walks F in order on one core and
// carries the down-projection sum in scratch from one grid step to the next;
// blocks on the GPU run in no order, so that accumulator does not carry
// over. Two phases instead, one wrapper call:
//   A: every block normalizes its rows, dequantizes its gate and up columns
//      of the fused [K, 2F] gateup weight, and writes
//      act = bf16(silu(gate f32)) * bf16(up) into an [M, F] bf16 scratch --
//      the act is rounded to bf16 exactly where the TPU kernel rounds it;
//   B: the down projection over act with an f32 accumulator, the residual
//      added in f32 and the result cast to bf16 once (K1's device code).
// Where both phases fit the tensor-core GEMV (dq_gemv_tc.cuh: W4/W8, g 64
// or 128, M <= 8, widths and pointers aligned; the caller passes each
// phase's cluster), a phase is one launch of it, MODE 1 and MODE 2, its K
// split over a thread-block cluster, and the call two launches. Otherwise
// each phase runs dq_core's GEMV and splits K across blocks as the caller
// asks (where its grid would not fill the card; then a small launch adds the
// f32 partial sums), so one call is two to four launches.
// Bound on an H100: the packed bytes of the three weights (about 18 MB a
// layer at TinyLlama W4 g128); the act round trip is M*F*2 bytes (90 KB at
// M = 8), small beside them. Every weight byte is read once per call.
#include "dq_gemv_tc.cuh"

using namespace qtpu;

template <int BITS>
static int mlp_dispatch(const DqArgs& a, const DqArgs& b, bool resid, cudaStream_t st) {
  int e = launch_dq<BITS, 8, 8, 1>(a, st);
  if (e != 0) return e;
  return resid ? launch_dq<BITS, 8, 8, 2>(b, st) : launch_dq<BITS, 8, 8, 0>(b, st);
}

// x [M, K] bf16, nw [K] bf16; gate/up packed [K/PK, 2F] with scales/zeros
// [K/g, 2F]; down packed [F/PK, K] with scales/zeros [F/g, K]; act [M, F]
// bf16 scratch; out [M, K] bf16. Phase A takes split_a groups of K per
// block slice (with more than one slice, part_a is an f32 scratch of
// slices * 2 * M * F), phase B split_b groups of F (part_b of slices * M * K).
// cluster_a, cluster_b > 0: both phases on the tensor-core GEMV, K split
// into that many slices of split_a / split_b groups (parts unused); both 0:
// dq_core's GEMV. resid = 0: phase B leaves the residual out. Returns a
// cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int qtpu_fused_mlp(const void* x, const void* nw, const void* gu_data,
                              const void* gu_scales, const void* gu_zeros,
                              const void* d_data, const void* d_scales,
                              const void* d_zeros, void* act, void* out, void* part_a,
                              int split_a, void* part_b, int split_b, int cluster_a,
                              int cluster_b, int M, int K, int F, int bits, int group,
                              int resid, float eps, void* stream) {
  if (M <= 0 || M > 32 || K % 4 != 0 || F % 4 != 0 || group <= 0 || group % 4 != 0 ||
      K % group != 0 || F % group != 0 || gu_zeros == nullptr || d_zeros == nullptr)
    return -1;
  DqArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.data = static_cast<const int8_t*>(gu_data);
  a.scales = static_cast<const __nv_bfloat16*>(gu_scales);
  a.zeros = static_cast<const uint8_t*>(gu_zeros);
  a.nw = static_cast<const __nv_bfloat16*>(nw);
  a.out = static_cast<__nv_bfloat16*>(act);
  a.part = static_cast<float*>(part_a);
  a.M = M;
  a.K = K;
  a.N = F;
  a.ldw = 2 * F;
  a.group = group;
  a.split_groups = split_a;
  a.eps = eps;
  DqArgs b{};
  b.x = static_cast<const __nv_bfloat16*>(act);
  b.data = static_cast<const int8_t*>(d_data);
  b.scales = static_cast<const __nv_bfloat16*>(d_scales);
  b.zeros = static_cast<const uint8_t*>(d_zeros);
  b.resid = resid ? static_cast<const __nv_bfloat16*>(x) : nullptr;
  b.out = static_cast<__nv_bfloat16*>(out);
  b.part = static_cast<float*>(part_b);
  b.M = M;
  b.K = F;
  b.N = K;
  b.ldw = K;
  b.group = group;
  b.split_groups = split_b;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster_a > 0 || cluster_b > 0) {
    if (cluster_a <= 0 || cluster_b <= 0 || !gemv_tc_fits(a, bits, cluster_a, split_a) ||
        !gemv_tc_fits(b, bits, cluster_b, split_b))
      return -1;
    const int e = gemv_tc<1>(a, bits, cluster_a, split_a, st);
    if (e != 0) return e;
    return resid ? gemv_tc<2>(b, bits, cluster_b, split_b, st)
                 : gemv_tc<0>(b, bits, cluster_b, split_b, st);
  }
  switch (bits) {
    case 4: return mlp_dispatch<4>(a, b, resid != 0, st);
    case 8: return mlp_dispatch<8>(a, b, resid != 0, st);
    default: return -1;
  }
}
