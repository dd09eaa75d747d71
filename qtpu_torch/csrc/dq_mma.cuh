// Tensor-core dequant-matmul for M > 8, shared by K1 (dequant_matmul.cu),
// K7 (codebook_matmul.cu) and K9 (moe_matmul.cu).
//
// mma.sync m16n8k16, bf16 in, f32 accumulate. The B operand is the integer
// code minus the zero point (K1), exact in bf16, or the code's codebook
// level rounded to bf16 (K7, CB); each group's f32 sum is scaled by the
// group's scale before it joins the accumulator, the per-group f32
// correction the TPU kernels apply to their output tile. It needs
// g / PK packed rows per group to be a multiple of 16 (W4: g a multiple of
// 32); ragged M and N edges are masked (N % 4 != 0 in the VEC = false
// build, whose unaligned rows are read byte by byte: dq_core.cuh's
// ld_cols4_u8).
#pragma once

#include "dq_core.cuh"

namespace qtpu {

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
// The body is a device function so that the expert kernel of moe_matmul.cu
// runs it on one expert's pointers.
template <int BITS, bool CB, bool VEC = true>
__device__ __forceinline__ void dq_mma_body(const DqArgs& a) {
  constexpr int PK = 8 / BITS;
  constexpr int KS = kMmaRows * PK;  // K values per stage
  constexpr int LDS = KS + 8;        // padded smem row, in bf16
  constexpr int Z_SYM = 1 << (BITS - 1);
  __shared__ __align__(16) __nv_bfloat16 xs[kMmaBM * LDS];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 ws[kMmaBN * LDS];  // [n][k], codes - zero or levels
  __shared__ float lut[16];

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
  const bool wcol_ok = n0 + wc < a.N;  // columns past N read as 0 (ragged N)

  float acc[2][4][4];
  float grp[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = grp[i][j][e] = 0.f;
  int z[4] = {Z_SYM, Z_SYM, Z_SYM, Z_SYM};
  if (CB && tid < 16) lut[tid] = a.cb[tid];  // read after the first stage's barriers

  for (int st = 0; st < stages; ++st) {
    const int c = st / per_group;
    const int j0 = (st - c * per_group) * kMmaRows;
    if (!CB && j0 == 0 && a.zeros != nullptr && wcol_ok) {
      const uint32_t zw = ld_cols4_u8<VEC>(
          reinterpret_cast<const int8_t*>(a.zeros) + (size_t)c * a.ldw + n0 + wc, n0 + wc, a.N);
#pragma unroll
      for (int t = 0; t < 4; ++t) z[t] = (zw >> (8 * t)) & 0xff;
    }
    const uint32_t word =
        wcol_ok ? ld_cols4_u8<VEC>(a.data + (size_t)(c * R + j0 + wr) * a.ldw + n0 + wc, n0 + wc,
                                   a.N)
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
        ws[(wc + t) * LDS + p * 16 + wr] =
            CB ? __float2bfloat16(wcol_ok ? lut[q] : 0.f) : __int2bfloat16_rn(wcol_ok ? q - z[t] : 0);
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

template <int BITS, bool CB, bool VEC>
__global__ void __launch_bounds__(kThreads) dq_mma_kernel(DqArgs a) {
  dq_mma_body<BITS, CB, VEC>(a);
}

// Launches dq_mma_kernel over the whole of K (no split); VEC as in
// launch_dq. Returns the cudaError_t of the launch, or -1 for an N the
// build does not take.
template <int BITS, bool CB, bool VEC = true>
inline int launch_dq_mma(const DqArgs& a, cudaStream_t st) {
  if (VEC && (a.N % 4 != 0 || a.ldw % 4 != 0)) return -1;
  dim3 grid((a.N + kMmaBN - 1) / kMmaBN, (a.M + kMmaBM - 1) / kMmaBM);
  dq_mma_kernel<BITS, CB, VEC><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace qtpu
