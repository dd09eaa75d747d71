// K7: codebook matmul for POT/APOT W4 weights.
//
// Replaces the TPU kernel pallas_codebook_matmul
// (qtpu/kernels/pallas_dequant_matmul.py:324):
//   y[M, N] = x[M, K] @ (scales o codebook[codes]),
// codes int4 in K1's W4 layout (group-halves, excess-8 high nibble), scales
// bf16 [K/g, N], a level table of at most 16 f32 values. A layer of a
// stacked weight is its zero-copy view.
//
// Bound on an H100: at decode (M = 8) the packed bytes (K*N/2 plus the
// scales); at prefill and eval (M = 1024-2048) the multiply-adds. The design
// is K1's with a 16-entry f32 table in shared memory (16 consecutive floats,
// one bank each, so any lookup pattern of a warp is conflict-free) in place
// of (q - z):
//  * M <= 8 where gemv_tc_fits takes the call (g 64 or 128, N % 16 == 0,
//    16-byte aligned codes and scales): the tensor-core GEMV of
//    dq_gemv_tc.cuh in its codebook mode (MODE 3: the level rounded to bf16
//    from a byte table, each group's f32 product times its f32 scale);
//  * other M <= 8 calls: the weight-streaming GEMV of dq_core.cuh in its
//    codebook mode (w = level * scale in f32), K split across lanes and blocks;
//  * M > 8, g 64 or 128, N % 16 == 0 and the codes and scales 16-byte
//    aligned (wgmma_fits): dq_wgmma_kernel of dq_wgmma.cuh (wgmma fed by TMA)
//    with the level rounded to bf16 as the weight operand (POT levels are
//    exact in bf16, APOT's are not) and each group's f32 sum scaled by its
//    f32 scale;
//  * other M > 8 calls: dq_mma_kernel of dq_mma.cuh, the same arithmetic on
//    mma.sync with synchronous loads.
// The TPU kernel looks the level up with a select chain and multiplies the
// group's product by the scale; the plain version (qtpu's XLA reference)
// rounds level * scale to bf16 instead, a difference of the kind K1 has.
#include "dq_gemv_tc.cuh"
#include "dq_mma.cuh"
#include "dq_wgmma.cuh"

using namespace qtpu;

namespace {

// VEC: the vector-load build for N % 4 == 0, else the byte-load build.
template <bool VEC>
int cb_dispatch(const DqArgs& a, cudaStream_t st) {
  if (a.M <= 8 || (a.group / 2) % kMmaRows != 0) return launch_dq<4, 8, 8, 3, VEC>(a, st);
  if (a.split_groups != a.K / a.group) return -1;  // the mma path does not split K
  return launch_dq_mma<4, true, VEC>(a, st);
}
}  // namespace

// y[M, N] = x[M, K] @ (scales o cb[codes]); cb: 16 f32 levels on the device
// (unused entries padded). x must be 16-byte aligned. split_groups and part
// as in qtpu_dq_matmul (split K only at M <= 8), and cluster (> 0: the
// tensor-core GEMV). Returns a cudaError_t (0 on success), or -1 for
// arguments the kernel does not take.
extern "C" int qtpu_cb_matmul(const void* x, const void* data, const void* scales,
                              const void* cb, void* out, void* part, int split_groups,
                              int cluster, int M, int K, int N, int group, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group <= 0 || group % 4 != 0 ||
      K % group != 0 || cb == nullptr)
    return -1;
  DqArgs a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.data = static_cast<const int8_t*>(data);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.cb = static_cast<const float*>(cb);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.K = K;
  a.N = N;
  a.ldw = N;
  a.group = group;
  a.split_groups = split_groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) return gemv_tc<3>(a, 4, cluster, split_groups, st);
  if (wgmma_fits(a)) return launch_dq_wgmma<4, true>(a, st);
  return N % 4 == 0 ? cb_dispatch<true>(a, st) : cb_dispatch<false>(a, st);
}
