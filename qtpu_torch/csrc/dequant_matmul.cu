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
//  * M <= 8: the weight-streaming GEMV of dq_core.cuh (each weight byte read
//    once, dequantized in registers, K split across lanes and blocks so
//    enough loads are in flight for the narrow decode shapes);
//  * M > 8: dq_mma_kernel below, on the tensor cores (mma.sync m16n8k16,
//    bf16 in, f32 accumulate). Its B operand is the integer code minus the
//    zero point, exact in bf16, so no weight is rounded; each group's f32
//    sum is scaled by the group's scale before it joins the accumulator,
//    the per-group f32 correction the TPU kernel applies to its output tile.
//    It needs g / PK packed rows per group to be a multiple of 16 (W4: g a
//    multiple of 32); other groups take the GEMV path tiled over M.
// Ragged M and N edges are masked in the kernels, so no caller pads.
#include "dq_core.cuh"

using namespace qtpu;

namespace {

constexpr int kMmaBM = 128;   // rows of x per block
constexpr int kMmaBN = 64;    // output columns per block
constexpr int kMmaRows = 16;  // packed weight rows per stage

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 warps as 4 (rows) x 2 (columns), each a 32 x 32 tile of 2 x 4 mma tiles.
// A stage covers 16 packed rows of one group, i.e. PK runs of 16 K values.
template <int BITS>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(DqArgs a) {
  constexpr int PK = 8 / BITS;
  constexpr int KS = kMmaRows * PK;  // K values per stage
  constexpr int LDS = KS + 8;        // padded smem row, in bf16
  constexpr int Z_SYM = 1 << (BITS - 1);
  __shared__ __align__(16) __nv_bfloat16 xs[kMmaBM * LDS];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 ws[kMmaBN * LDS];  // [n][k], codes - zero

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  const int m0 = blockIdx.y * kMmaBM;
  const int n0 = blockIdx.x * kMmaBN;
  const int g = a.group;
  const int R = g / PK;
  const int per_group = R / kMmaRows;
  const int stages = a.K / KS;
  // weight loader role: packed row wr of the stage, columns wc .. wc + 3
  const int wr = tid % kMmaRows;
  const int wc = 4 * (tid / kMmaRows);
  const bool wcol_ok = n0 + wc < a.N;  // N % 4 == 0

  float acc[2][4][4];
  float grp[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = grp[i][j][e] = 0.f;
  int z[4] = {Z_SYM, Z_SYM, Z_SYM, Z_SYM};

  for (int st = 0; st < stages; ++st) {
    const int c = st / per_group;
    const int j0 = (st - c * per_group) * kMmaRows;
    if (j0 == 0 && a.zeros != nullptr && wcol_ok) {
      const uint32_t zw =
          __ldg(reinterpret_cast<const unsigned int*>(a.zeros + (size_t)c * a.ldw + n0 + wc));
#pragma unroll
      for (int t = 0; t < 4; ++t) z[t] = (zw >> (8 * t)) & 0xff;
    }
    const uint32_t word =
        wcol_ok ? __ldg(reinterpret_cast<const unsigned int*>(
                      a.data + (size_t)(c * R + j0 + wr) * a.ldw + n0 + wc))
                : 0u;
    __syncthreads();  // the previous stage is consumed
    // x: every row's PK runs of 16 K values, 16 bytes per load
    for (int i = tid; i < kMmaBM * PK * 2; i += kThreads) {
      const int m = i / (PK * 2);
      const int p = (i / 2) % PK;
      const int half = i % 2;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < a.M)
        v = __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(m0 + m) * a.K + c * g +
                                                 p * R + j0 + 8 * half));
      *reinterpret_cast<uint4*>(xs + m * LDS + p * 16 + 8 * half) = v;
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t b = (word >> (8 * t)) & 0xffu;
#pragma unroll
      for (int p = 0; p < PK; ++p) {
        int q;
        if (BITS == 8) {
          q = (int)(b ^ 0x80u);
        } else if (BITS == 4) {
          q = p == 0 ? (int)(b & 0xfu) : (int)((b >> 4) ^ 8u);
        } else {
          q = (int)((b >> (2 * p)) & 3u);
        }
        ws[(wc + t) * LDS + p * 16 + wr] = __int2bfloat16_rn(wcol_ok ? q - z[t] : 0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < PK; ++p) {
      const int kb = p * 16 + (lane % 4) * 2;
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* r0 = xs + (wm + mi * 16 + lane / 4) * LDS + kb;
        af[mi][0] = ld_pair(r0);
        af[mi][1] = ld_pair(r0 + 8 * LDS);
        af[mi][2] = ld_pair(r0 + 8);
        af[mi][3] = ld_pair(r0 + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* c0 = ws + (wn + ni * 8 + lane / 4) * LDS + kb;
        bf[ni][0] = ld_pair(c0);
        bf[ni][1] = ld_pair(c0 + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(grp[mi][ni], af[mi], bf[ni]);
    }
    if (j0 + kMmaRows == R) {  // the group is complete: scale it in f32
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn + ni * 8 + (lane % 4) * 2 + e;
          const float s = col < a.N ? bf2f(a.scales[(size_t)c * a.ldw + col]) : 0.f;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            acc[mi][ni][e] = fmaf(s, grp[mi][ni][e], acc[mi][ni][e]);
            acc[mi][ni][e + 2] = fmaf(s, grp[mi][ni][e + 2], acc[mi][ni][e + 2]);
            grp[mi][ni][e] = 0.f;
            grp[mi][ni][e + 2] = 0.f;
          }
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + lane / 4 + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + (lane % 4) * 2 + (e & 1);
        if (row < a.M && col < a.N)
          a.out[(size_t)row * a.N + col] = __float2bfloat16(acc[mi][ni][e]);
      }
}

template <int BITS>
int dq_dispatch(const DqArgs& a, cudaStream_t st) {
  constexpr int PK = 8 / BITS;
  if (a.M <= 8 || (a.group / PK) % kMmaRows != 0) return launch_dq<BITS, 8, 8, 0>(a, st);
  if (a.split_groups != a.K / a.group) return -1;  // the mma path does not split K
  dim3 grid((a.N + kMmaBN - 1) / kMmaBN, (a.M + kMmaBM - 1) / kMmaBM);
  dq_mma_kernel<BITS><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// y[M, N] = x[M, K] @ dequant(data, scales, zeros); x must be 16-byte
// aligned. split_groups: groups of K per block slice, K / group for no split;
// with more than one slice (M <= 8 only), `part` is an f32 scratch of
// slices * M * N. Returns a cudaError_t (0 on success), or -1 for arguments
// the kernel does not take.
extern "C" int qtpu_dq_matmul(const void* x, const void* data, const void* scales,
                              const void* zeros, void* out, void* part, int split_groups,
                              int M, int K, int N, int bits, int group, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || N % 4 != 0 || group <= 0 || group % 4 != 0 ||
      K % group != 0)
    return -1;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return dq_dispatch<2>(a, st);
    case 4: return dq_dispatch<4>(a, st);
    case 8: return dq_dispatch<8>(a, st);
    default: return -1;
  }
}
