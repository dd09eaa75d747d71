// K6: W8A8 matmul, dynamic per-token int8 activations times per-channel
// int8 weights on the int8 tensor cores.
//
// Replaces the TPU kernel pallas_w8a8_matmul
// (qtpu/kernels/pallas_int8_matmul.py:58), the SmoothQuant W8A8 serving
// linear. With d = data, the stored value-minus-128 int8 container [K, N]
// (n contiguous), s bf16 [N] and z uint8 [N]:
//   sx[m]    = max(max_k |x[m, k]| * (1/127), 1e-8)
//   xq[m, k] = clamp(rint(x[m, k] / sx[m]), -127, 127)             int8
//   acc[m, n] = sum_k xq[m, k] * d[k, n]                            int32, exact
//   y[m, n]  = float(acc + (sum_k xq[m, k]) * (128 - z[n])) * s[n] * sx[m]
// The zero-point correction is rank 1 because the weight has one group
// spanning K. |acc| + |correction| <= 2 * 127 * 128 * K < 2^31 for
// K < 66,000, so the int32 sum never overflows at the widths served.
//
// Bound on an H100: at decode (M <= 8) the K*N weight bytes; at prefill and
// eval (M = 1024-2048) the multiply-adds at the int8 tensor-core rate, or
// the bytes for narrow N. What the design does about it:
//  * w8a8_quant_kernel, the first launch of every call: one block per token
//    row (16-byte loads) computes sx, xq and sum(xq) into a small scratch (int8 [M, Kp] with
//    Kp = K rounded up to 64 and zero-filled, f32 [M], int32 [M]). The TPU
//    kernel recomputes the quantization per N tile instead; on the card the
//    [M, K] int8 round trip is 1/2 of the bf16 x it replaces and lets the
//    matmul read 1-byte activations. The rounding is that of qtpu's jitted
//    XLA reference: XLA folds absmax / 127 into a multiply by the f32
//    reciprocal, x / sx stays a true division, and __float2int_rn rounds
//    half to even as jnp.round does.
//  * M > 8 where w8a8_wgmma_fits holds (N % 16 == 0, the weight and scales
//    16-byte aligned): w8a8_wgmma_kernel, the Hopper route, below;
//  * the other M > 8 calls: w8a8_mma_kernel, mma.sync m16n8k32 s8 x s8 -> s32
//    (qtpu_w8a8_matmul_mma runs it on any M > 8 call, the route's earlier
//    body kept for comparison on the same bytes). A block owns
//    128 rows x 64 columns (8 warps as 4 x 2, each 32 x 32); a 64-deep K
//    stage of xq and of d goes through shared memory, the next stage's
//    global loads are issued into registers before this stage's products
//    (one stage of prefetch, no cp.async yet). The B fragment wants 4
//    consecutive k of one column in each 32-bit register but d is [K, N]
//    with n contiguous: each thread loads a 4 x 4 byte block (4 rows of one
//    32-bit word) and transposes it with __byte_perm while staging, so the
//    stored layout stays the one both packages share.
//  * M <= 8 where w8a8_gemv_tc_fits holds (N % 16 == 0, K % 32 == 0, x and
//    the weight 16-byte aligned, the wrapper's split of K over a
//    thread-block cluster): w8a8_gemv_tc_kernel, one launch on the int8
//    tensor cores, below the dp4a body;
//  * the other M <= 8 calls (and qtpu_w8a8_matmul with cluster 0, the
//    earlier body kept for comparison on the same bytes, three launches):
//    w8a8_gemv_kernel, a weight-streaming GEMV: each lane owns 8
//    columns (one 8-byte load per K row, 256 bytes per warp per row), each
//    warp a strided set of 4-row groups, transposed with __byte_perm and
//    multiplied with __dp4a against each row's xq word, read from the
//    block's slice of xq staged in shared memory. K is also split across
//    blocks (the caller picks the slice, as K1's split_k does) so the
//    2048-wide sites fill the SMs and each slice's xq fits the stage; the
//    slices' int32 sums are added exactly by w8a8_finish_kernel, which
//    applies the epilogue.
//  * a row-parallel site under tensor parallelism (a rank holds a slice of
//    K, the per-token scale spans all of it): w8a8_quant_kernel's
//    absmax-out mode (qtpu_w8a8_absmax) writes each token's |x| max of the
//    slice, the caller all-reduces it (MAX), and every body quantizes with
//    it through a.amax_in (the quantize kernel; the tensor-core GEMV in
//    place of its cluster's maxima) and writes, in place of y, the int32
//    acc + Σxq (128 - z) of the rank's K slice (a.out_total). The caller
//    sums that over the group (exact) and w8a8_epilogue_kernel rescales it,
//    so the ranks' bits are one rank's whole product's; fed the rank's own
//    absmax, the rescaled sums are the usual mode's bits (a rank's product
//    rounded to bf16 and then summed put the 22-layer TinyLlama W8A8 at TP
//    2 0.12 from its one-rank logits on an H100; f32 partials 0.078).
//
// The tensor-core GEMV (w8a8_gemv_tc_kernel) follows dq_gemv_tc.cuh (K1's
// decode GEMV) and shares its cp.async helpers. Bound at decode: the K N
// weight bytes (TinyLlama's q/o site 4.2 MB, 1.3 us at 3.35 TB/s). The dp4a
// body pays three launches a call (quantize, GEMV, finish), an [M, Kp] xq
// and a split-K int32 round trip, and a 4 x 4 byte transpose plus 8 dp4a a
// lane for every 32 bytes. Here one launch does it all: a block quantizes
// its own slice of x (the cluster agrees on sx through distributed shared
// memory), mma.sync m16n8k32 multiplies a 16-column x 32-K tile of the
// weight by all 8 rows of xq (a lane spends half a byte_perm a weight byte
// and 1/16 of an mma), the weight streams by 16-byte cp.async into a per-lane
// shared ring (2 steps, 256 bytes a lane, in flight), and the cluster adds
// its blocks' int32 sums through distributed shared memory.
//
// The Hopper route (w8a8_wgmma_kernel), wgmma fed by TMA in the pattern of
// dq_wgmma.cuh (K1's route) and with its helpers (tma.cuh). A persistent
// grid (at most one block an SM) walks the 128 x 128 output tiles along M
// first, so the blocks that run together share the weight's columns through
// L2 (xq, at most 11.5 MB at the eval block's down site, stays there). A
// stage is 128 K values: xq's [128 rows, 128] box and the weight's
// [128 K rows, 128 columns] box, both by TMA with the 128-byte swizzle, into
// a ring of 6 slots that a producer warpgroup (one thread, setmaxnreg 40)
// refills as soon as the 8 consumer warps have released a slot.
//  * 8-bit wgmma reads both shared-memory operands K-major, and d is stored
//    N-major (the layout both packages share). So the route computes each
//    tile's transpose, outT = dT xqT ("weight as A", as K1's route): the
//    weight is wgmma's A operand in registers, xq (K-major, as the
//    quantization writes it) is B from shared memory. The A fragment holds 4
//    consecutive K of one weight column a register; a thread's two A rows
//    are the adjacent columns nc, nc + 1 (the rows' order is ours to choose;
//    the epilogue undoes it), so one 16-bit shared load reads both columns
//    of a K row, and two byte_perms a register pair transpose 4 rows into 4
//    K of each column. Lanes q = 2, 3 of a quad load their 4 rows in the
//    order 2, 3, 0, 1 (their rows 8 apart from q = 0, 1's share a swizzle
//    chunk), so a warp's 16-bit loads hit 16 distinct banks; the last
//    byte_perm's selector undoes the order. The other way, a transpose of
//    the weight tile inside shared memory into a K-major B operand, was not
//    taken: it adds a 16 KB read and write a stage to the shared memory
//    that TMA and wgmma already load, where the fragments cost 32 16-bit
//    loads and 32 byte_perms a thread a stage.
//  * Two consumer warpgroups (weight columns 0-63 and 64-127 of the tile)
//    run wgmma.mma_async m64n128k32 s8 x s8 -> s32 over the stage's 4 K
//    steps; the next stage's fragments are loaded while the tensor cores
//    run this one (two buffers of 16 registers), as in K1's route. One group
//    spans K, so there is no per-group scale: the int32 accumulator runs
//    over all of K, exact, and the epilogue is w8a8_out's, per row of outT
//    (s, z of the weight column) and per column (sx, sum(xq) of the token),
//    in the same float order: the route's bits equal the mma.sync body's.
//  * TMA zero-fills the boxes past M, Kp and K (the ring's expect_tx counts
//    whole boxes); the epilogue masks rows >= M and columns >= N. The route
//    rule (w8a8_wgmma_fits) is mirrored by w8a8_route in
//    qtpu_torch/kernels/int8_matmul.py; a failed encode or launch returns
//    its error, which the wrapper raises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dq_gemv_tc.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;       // mma: rows per block
constexpr int kBN = 64;        // mma: columns per block
constexpr int kBK = 64;        // mma: K bytes per stage; Kp is a multiple
constexpr int kLD = kBK + 16;  // padded shared row, bytes
constexpr int kGemvThreads = 128;  // gemv: 4 warps
constexpr int kGemvRows = 8;       // gemv: most rows M
constexpr int kGemvCols = 256;     // gemv: columns per block (32 lanes x 8)
constexpr int kGemvUnroll = 4;     // gemv: 4-row groups in flight per warp
constexpr int kGemvWarps = kGemvThreads / 32;
// gemv: int32 words of shared memory, the slice's xq (M * split_rows / 4
// words at most) and then the cross-warp reduction
constexpr int kGemvSmem = kGemvWarps * kGemvRows * kGemvCols;

struct W8A8Args {
  const __nv_bfloat16* x;       // [M, K]
  const int8_t* data;           // [K, N], w_q - 128
  const __nv_bfloat16* scales;  // [N]
  const uint8_t* zeros;         // [N]
  __nv_bfloat16* out;           // [M, N]
  int8_t* xq;                   // [M, Kp] scratch
  float* sx;                    // [M] scratch
  int* sumq;                    // [M] scratch
  int* part;                    // gemv split K: int32 [splits, M, N], else nullptr
  const float* amax_in;         // [M] the per-token absmax to quantize with, else nullptr
  float* amax_out;              // [M] absmax out: the quantize kernel writes it, nothing else
  int* out_total;               // [M, N] with amax_in: acc + Σxq (128 - z) in place of out
  int M, K, Kp, N;
  int split_rows;               // gemv: K rows per blockIdx.y
};

// y = float(acc + Σxq (128 - z)) s sx, in this float order everywhere.
__device__ __forceinline__ float w8a8_y(int acc, int sumq, float sx, __nv_bfloat16 s,
                                        uint8_t z) {
  const int total = acc + sumq * (128 - (int)z);
  return ((float)total * __bfloat162float(s)) * sx;
}

// Output element i of row m, column n from its int32 sum acc and the row's
// Σxq: y in bf16, or with a given absmax (a.out_total, a tensor-parallel
// rank's K slice) the integer acc + Σxq (128 - z), which the group sums
// exactly before w8a8_epilogue_kernel applies the rescale.
__device__ __forceinline__ void w8a8_store(const W8A8Args& a, size_t i, int n, int acc, int sumq,
                                           float sx) {
  if (a.out_total != nullptr)
    a.out_total[i] = acc + sumq * (128 - (int)a.zeros[n]);
  else
    a.out[i] = __float2bfloat16(w8a8_y(acc, sumq, sx, a.scales[n], a.zeros[n]));
}

// 4 rows of 4 bytes (r[i] = row i, bytes = columns) -> 4 columns of 4 bytes
// (c[j] = column j, bytes = rows).
__device__ __forceinline__ void transpose4x4(const uint32_t* r, uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// Block-wide max (op 0) or sum (op 1) of one value per thread.
template <typename T, int OP>
__device__ __forceinline__ T block_reduce(T v, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(0xffffffffu, v, o);
    v = OP == 0 ? max(v, w) : v + w;
  }
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  v = scratch[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) v = OP == 0 ? max(v, scratch[w]) : v + scratch[w];
  return v;
}

__device__ __forceinline__ int quant1(float v, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

// One block per token row; 16-byte loads of 8 activations where the row
// is 16-byte aligned, else one activation per thread and step. Two modes
// for a row-parallel site under tensor parallelism: with a.amax_out the
// row's |x| max is written there and nothing else (the absmax pass over
// the rank's K slice); with a.amax_in the row is quantized with that
// absmax (the all-reduced one) in place of its own.
__global__ void __launch_bounds__(kThreads) w8a8_quant_kernel(W8A8Args a) {
  __shared__ float smax[kThreads / 32];
  __shared__ int ssum[kThreads / 32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const __nv_bfloat16* xr = a.x + (size_t)row * a.K;
  int8_t* qr = a.xq + (size_t)row * a.Kp;
  const bool vec = a.K % 8 == 0 && reinterpret_cast<uintptr_t>(xr) % 16 == 0;
  const int nvec = vec ? a.K / 8 : 0;  // 8-wide chunks; the rest one by one
  float amax = 0.f;
  if (a.amax_in != nullptr) {
    amax = a.amax_in[row];
  } else {
    for (int c = tid; c < nvec; c += kThreads) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr) + c);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(h[i])));
    }
    for (int k = 8 * nvec + tid; k < a.K; k += kThreads) amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
    amax = block_reduce<float, 0>(amax, smax);
    if (a.amax_out != nullptr) {
      if (tid == 0) a.amax_out[row] = amax;
      return;
    }
  }
  const float s = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-8f);
  int sum = 0;
  for (int c = tid; c < nvec; c += kThreads) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr) + c);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = quant1(__bfloat162float(h[i]), s);
      sum += q;
      w[i / 4] |= (uint32_t)(q & 0xff) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(qr + 8 * c) = make_uint2(w[0], w[1]);
  }
  for (int k = 8 * nvec + tid; k < a.Kp; k += kThreads) {
    const int q = k < a.K ? quant1(__bfloat162float(xr[k]), s) : 0;  // zero padding to Kp
    qr[k] = (int8_t)q;
    sum += q;
  }
  sum = block_reduce<int, 1>(sum, ssum);
  if (tid == 0) {
    a.sx[row] = s;
    a.sumq[row] = sum;
  }
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads) w8a8_mma_kernel(W8A8Args a) {
  __shared__ __align__(16) int8_t as[kBM * kLD];  // [m][k] xq
  __shared__ __align__(16) int8_t bs[kBN * kLD];  // [n][k] d, transposed
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp % 4) * 32;
  const int wn = (warp / 4) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  // loaders: xq as 2 x 16 bytes a thread; d as one 4 x 4 byte block a thread
  const int kq = tid / 16;  // 4-row group of the stage, 0..15
  const int nq = tid % 16;  // 4-column group of the block, 0..15
  const bool bcol = n0 + 4 * nq < a.N;  // N % 4 == 0
  uint4 ra[2];
  uint32_t rb[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kThreads;
      const int m = i / (kBK / 16);
      const int c = i % (kBK / 16);
      ra[r] = m0 + m < a.M
                  ? __ldg(reinterpret_cast<const uint4*>(a.xq + (size_t)(m0 + m) * a.Kp + k0 + 16 * c))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * kq + j;
      rb[j] = bcol && k < a.K
                  ? __ldg(reinterpret_cast<const unsigned int*>(a.data + (size_t)k * a.N + n0 + 4 * nq))
                  : 0u;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid + r * kThreads;
      *reinterpret_cast<uint4*>(as + (i / (kBK / 16)) * kLD + 16 * (i % (kBK / 16))) = ra[r];
    }
    uint32_t col[4];
    transpose4x4(rb, col);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(bs + (4 * nq + j) * kLD + 4 * kq) = col[j];
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int stages = a.Kp / kBK;
  load(0);
  store();
  __syncthreads();
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) load((st + 1) * kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[2][4];
      uint32_t bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = as + (wm + mi * 16 + g) * kLD + kk + 4 * t;
        af[mi][0] = ld_s32(r0);
        af[mi][1] = ld_s32(r0 + 8 * kLD);
        af[mi][2] = ld_s32(r0 + 16);
        af[mi][3] = ld_s32(r0 + 8 * kLD + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = bs + (wn + ni * 8 + g) * kLD + kk + 4 * t;
        bf[ni][0] = ld_s32(c0);
        bf[ni][1] = ld_s32(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    if (st + 1 < stages) {
      __syncthreads();  // this stage is consumed
      store();
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (row < a.M && col < a.N)
          w8a8_store(a, (size_t)row * a.N + col, col, acc[mi][ni][e], a.sumq[row], a.sx[row]);
      }
}

// 4 warps; a lane owns 8 adjacent columns (one 8-byte load per K row), a
// warp the block's 256 columns, and the warps take the slice's 4-row groups
// in turn.
__global__ void __launch_bounds__(kGemvThreads) w8a8_gemv_kernel(W8A8Args a) {
  constexpr int kWarps = kGemvWarps;
  // the slice's xq rows while the product runs, then the cross-warp reduction
  __shared__ __align__(16) int smem[kGemvSmem];
  auto red = reinterpret_cast<int(*)[kGemvRows][kGemvCols]>(smem);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kGemvCols + 8 * lane;
  const bool col_ok = n < a.N;
  // 8-byte loads where every row start is 8-byte aligned; else two 4-byte
  // loads (N % 4 == 0: a lane's last 4 columns may lie past N)
  const bool wide = a.N % 8 == 0 && reinterpret_cast<uintptr_t>(a.data) % 8 == 0;
  const bool hi_ok = n + 4 < a.N;
  const int kbeg = blockIdx.y * a.split_rows;
  const int kend = min(a.K, kbeg + a.split_rows);  // both multiples of 4
  const int words = (kend - kbeg) / 4;  // xq words of one row in the slice
  for (int i = threadIdx.x; i < a.M * words; i += kGemvThreads) {
    const int m = i / words;
    smem[i] = __ldg(reinterpret_cast<const int*>(a.xq + (size_t)m * a.Kp + kbeg) + i - m * words);
  }
  __syncthreads();
  int acc[kGemvRows][8];
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0;

  for (int k0 = kbeg + 4 * warp; k0 < kend; k0 += 4 * kWarps * kGemvUnroll) {
    uint2 w[kGemvUnroll][4];
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int k = k0 + u * 4 * kWarps;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = a.data + (size_t)(k + j) * a.N + n;
        w[u][j] = make_uint2(0u, 0u);
        if (col_ok && k < kend) {
          if (wide) {
            w[u][j] = __ldg(reinterpret_cast<const uint2*>(p));
          } else {
            w[u][j].x = __ldg(reinterpret_cast<const unsigned int*>(p));
            if (hi_ok) w[u][j].y = __ldg(reinterpret_cast<const unsigned int*>(p + 4));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGemvUnroll; ++u) {
      const int k = k0 + u * 4 * kWarps;
      if (k >= kend) break;
      const uint32_t lo[4] = {w[u][0].x, w[u][1].x, w[u][2].x, w[u][3].x};
      const uint32_t hi[4] = {w[u][0].y, w[u][1].y, w[u][2].y, w[u][3].y};
      uint32_t c[8];
      transpose4x4(lo, c);
      transpose4x4(hi, c + 4);
#pragma unroll
      for (int m = 0; m < kGemvRows; ++m) {
        if (m < a.M) {
          const int xw = smem[m * words + (k - kbeg) / 4];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[m][j] = __dp4a(xw, (int)c[j], acc[m][j]);
        }
      }
    }
  }
  __syncthreads();  // the staged xq is consumed
#pragma unroll
  for (int m = 0; m < kGemvRows; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp][m][8 * lane + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kGemvRows * kGemvCols; i += kGemvThreads) {
    const int m = i / kGemvCols;
    const int cc = i % kGemvCols;
    const int col = blockIdx.x * kGemvCols + cc;
    if (m >= a.M || col >= a.N) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][cc];
    if (a.part == nullptr) w8a8_store(a, (size_t)m * a.N + col, col, s, a.sumq[m], a.sx[m]);
    else a.part[((size_t)blockIdx.y * a.M + m) * a.N + col] = s;
  }
}

// Adds the K slices' int32 sums of w8a8_gemv_kernel and applies the epilogue.
__global__ void __launch_bounds__(kThreads) w8a8_finish_kernel(W8A8Args a, int splits) {
  const size_t mn = (size_t)a.M * a.N;
  for (size_t o = blockIdx.x * (size_t)kThreads + threadIdx.x; o < mn;
       o += (size_t)gridDim.x * kThreads) {
    int s = 0;
    for (int z = 0; z < splits; ++z) s += a.part[(size_t)z * mn + o];
    const int m = (int)(o / a.N);
    w8a8_store(a, o, (int)(o % a.N), s, a.sumq[m], a.sx[m]);
  }
}

// ------------------------------------ the decode GEMV on the tensor cores

using qtpu::gtc_commit;
using qtpu::gtc_cp16;
using qtpu::gtc_smem_u32;
using qtpu::gtc_wait;
using qtpu::kTcCols;
using qtpu::kTcMaxCluster;
using qtpu::kTcWarps;
using qtpu::kTcXCap;

constexpr int kW8TcK = 32;                    // K rows a step: one mma.sync m16n8k32
constexpr int kW8TcThreads = 32 * kTcWarps;   // 4 warps, each over all kTcCols columns
constexpr int kW8TcRing = 3;                  // steps a lane's ring holds (2 in flight)
constexpr int kW8TcRingBytes = kW8TcRing * 8 * 16 * kW8TcThreads;  // 8 rows x 16 bytes a lane
static_assert(kW8TcRingBytes >= kTcWarps * 1024 * 4, "the warps' sums reuse the ring");

// xq's row pitch in shared memory, bytes: rows 32 bytes apart modulo 128,
// so the 8-byte B loads of a warp (rows lane / 4, 32 bytes each) fill the
// 32 banks twice without a conflict
__host__ __device__ inline int w8tc_pitch(int slice) { return (slice + 127) / 128 * 128 + 32; }

// Dynamic shared memory for a K slice of `slice` rows: the align slack, the
// ring, x's slice (bf16), xq's (int8), the block's int32 sums [1024], then
// Σxq, the absmax and sx of its 8 rows.
inline int w8tc_smem(int slice) {
  return 16 + kW8TcRingBytes + 8 * slice * 2 + 8 * w8tc_pitch(slice) + 4096 + 3 * 8 * 4;
}

// The 8 mmas of one step: w[8] the lane's 8 K rows (16 columns each), b0/b1
// its B fragment. mma i takes columns 2 i and 2 i + 1 of the lane's 16 as
// A rows g and g + 8: two byte_perms of a row pair put column c's bytes of
// rows (0, 1) next to column c + 1's, two more make the 4 K rows of each
// column one register (the A fragment's 4 consecutive K of one row).
__device__ __forceinline__ void w8tc_step(const uint4* w, uint32_t b0, uint32_t b1,
                                          int (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t sel = (i & 1) ? 0x7362u : 0x5140u;  // bytes 2 (i % 2), + 1 of two words
    uint32_t wd[8];  // word i / 2 of each row: columns 4 (i / 2) .. + 3
#pragma unroll
    for (int r = 0; r < 8; ++r) wd[r] = reinterpret_cast<const uint32_t*>(&w[r])[i >> 1];
    const uint32_t p01 = __byte_perm(wd[0], wd[1], sel);  // [r0 c, r1 c, r0 c+1, r1 c+1]
    const uint32_t p23 = __byte_perm(wd[2], wd[3], sel);
    const uint32_t p45 = __byte_perm(wd[4], wd[5], sel);
    const uint32_t p67 = __byte_perm(wd[6], wd[7], sel);
    const uint32_t af[4] = {__byte_perm(p01, p23, 0x5410u),   // column 2i, rows 0-3
                            __byte_perm(p01, p23, 0x7632u),   // column 2i + 1, rows 0-3
                            __byte_perm(p45, p67, 0x5410u),   // column 2i, rows 4-7
                            __byte_perm(p45, p67, 0x7632u)};  // column 2i + 1, rows 4-7
    const uint32_t bf[2] = {b0, b1};
    mma_s8(acc[i], af, bf);
  }
}

// The M <= 8 call in one launch: grid (cluster x ceil(N / 128)), cluster
// (cluster, 1, 1), block kW8TcThreads; a.split_rows: the K rows of a slice.
// A block owns 128 output columns and one K slice; the cluster's blocks
// cover all of K for their columns. Each block stages its slice of x, takes
// its rows' absmax, and the cluster's maxima meet through distributed
// shared memory, so every block quantizes its slice with the same sx as
// w8a8_quant_kernel (the max is order-free; the same reciprocal multiply,
// true division and rounding). The products run over its slice: lane (g, t)
// of a warp reads K rows 8 t .. 8 t + 7 of the step's 32 (its A fragment's
// K 4 t .. 4 t + 3 and 16 + 4 t ..; the K order inside a step is ours, and
// B follows it: xq row g's 8 bytes at 8 t, one 8-byte load) and columns
// 16 g .. 16 g + 15. The warps' and then the cluster's int32 sums, and Σxq,
// are exact, so the epilogue (w8a8_y, w8a8_out's float order) gives the
// dp4a body's bits.
__global__ void __launch_bounds__(kW8TcThreads, 4) w8a8_gemv_tc_kernel(W8A8Args a, int cluster) {
  namespace cg = cooperative_groups;
  constexpr int T = kW8TcThreads;
  extern __shared__ uint8_t w8tc_smem_raw[];  // aligned to 16 by hand, as qg_smem
  uint8_t* ring = w8tc_smem_raw + ((16 - (gtc_smem_u32(w8tc_smem_raw) & 15)) & 15);
  const int slice = a.split_rows;
  const int pitch = w8tc_pitch(slice);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(ring + kW8TcRingBytes);  // [8][slice]
  int8_t* xq = reinterpret_cast<int8_t*>(xb + 8 * slice);                        // [8][pitch]
  int* sums = reinterpret_cast<int*>(xq + 8 * pitch);                            // [1024]
  int* rsum = sums + 1024;                               // [8] Σxq of the slice
  float* rmax = reinterpret_cast<float*>(rsum + 8);      // [8] absmax of the slice
  float* rsx = rmax + 8;                                 // [8] sx

  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int n0 = (blockIdx.x / cluster) * kTcCols;
  const int kbase = rank * slice;
  const int ksl = max(0, min(a.K, kbase + slice) - kbase);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lg = lane >> 2;
  const int lt = lane & 3;
  const int col = n0 + 16 * lg;  // the lane's first column
  const bool in = col < a.N;     // N % 16 == 0: all 16 columns or none
  const int nsteps = ksl / kW8TcK;
  const int per = (nsteps + kTcWarps - 1) / kTcWarps;
  const int ws = min(nsteps, warp * per);
  const int we = min(nsteps, ws + per);

  // ---- the weight's ring: step s's 8 rows of the lane into slot (s - ws) % RING
  auto issue = [&](int s, int slot) {
    const int8_t* src = a.data + (size_t)(kbase + kW8TcK * s + 8 * lt) * a.N + col;
    const uint32_t dst = gtc_smem_u32(ring) + (uint32_t)(slot * 8 * T + tid) * 16;
#pragma unroll
    for (int r = 0; r < 8; ++r) gtc_cp16(dst + r * T * 16, in ? src + (size_t)r * a.N : a.data, in);
  };
  // ---- x's slice by cp.async (its own group, first), under the ring's first loads
  const int chunks = ksl / 8;
  for (int i = tid; i < 8 * chunks; i += T) {
    const int m = i / chunks;
    const int k = 8 * (i - m * chunks);
    const bool ok = m < a.M;
    gtc_cp16(gtc_smem_u32(xb + m * slice + k), ok ? a.x + (size_t)m * a.K + kbase + k : a.x, ok);
  }
  gtc_commit();
#pragma unroll
  for (int p = 0; p < kW8TcRing - 1; ++p) {
    if (ws + p < we) issue(ws + p, p);
    gtc_commit();
  }
  gtc_wait<kW8TcRing - 1>();  // x's group (not the ring's)
  __syncthreads();

  // ---- sx: the rows' absmax over the slice, then over the cluster; or,
  // given (a.amax_in, tensor parallelism's all-reduced absmax), from it
  if (a.amax_in != nullptr) {
    if (tid < 8) rsx[tid] = fmaxf(__fmul_rn(tid < a.M ? a.amax_in[tid] : 0.f, 1.0f / 127.0f), 1e-8f);
  } else {
    for (int m = warp; m < 8; m += kTcWarps) {
      float amax = 0.f;
      const uint4* xr = reinterpret_cast<const uint4*>(xb + m * slice);
      for (int c = lane; c < chunks; c += 32) {
        const uint4 v = xr[c];
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(h[i])));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      if (lane == 0) rmax[m] = amax;
    }
    cl.sync();  // every block's maxima are in its shared memory
    if (tid < 8) {
      float mx[kTcMaxCluster];  // the blocks' maxima, loaded together
#pragma unroll
      for (int z = 0; z < kTcMaxCluster; ++z)
        mx[z] = z < cluster ? cl.map_shared_rank(rmax, z)[tid] : 0.f;
      float amax = 0.f;
#pragma unroll
      for (int z = 0; z < kTcMaxCluster; ++z) amax = fmaxf(amax, mx[z]);
      rsx[tid] = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-8f);
    }
  }
  __syncthreads();
  // ---- xq of the slice (quant1, as w8a8_quant_kernel) and its rows' Σxq
  for (int m = warp; m < 8; m += kTcWarps) {
    const float s = rsx[m];
    const uint4* xr = reinterpret_cast<const uint4*>(xb + m * slice);
    int sum = 0;
    for (int c = lane; c < chunks; c += 32) {
      const uint4 v = xr[c];
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
      uint32_t q4[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = quant1(__bfloat162float(h[i]), s);
        sum += q;
        q4[i / 4] |= (uint32_t)(q & 0xff) << (8 * (i % 4));
      }
      *reinterpret_cast<uint2*>(xq + m * pitch + 8 * c) = make_uint2(q4[0], q4[1]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) rsum[m] = sum;
  }
  __syncthreads();

  // ---- the warp's steps
  int acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;
  const int8_t* xrow = xq + lg * pitch + 8 * lt;  // B's column: row lg of xq
  for (int s = ws; s < we; ++s) {
    const int it = s - ws;
    gtc_wait<kW8TcRing - 2>();  // step s's copies have landed
    uint4 w[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      w[r] = *reinterpret_cast<const uint4*>(ring + ((it % kW8TcRing) * 8 * T + r * T + tid) * 16);
    // refill the slot step s - 1 used, RING - 1 steps ahead
    if (s + kW8TcRing - 1 < we) issue(s + kW8TcRing - 1, (it + kW8TcRing - 1) % kW8TcRing);
    gtc_commit();
    const uint2 b = *reinterpret_cast<const uint2*>(xrow + kW8TcK * s);
    w8tc_step(w, b.x, b.y, acc);
  }
  gtc_wait<0>();

  // ---- the warps' sums, the block's, then the cluster's
  __syncthreads();  // every warp is done with the ring (the sums reuse it)
  int* red = reinterpret_cast<int*>(ring);  // [kTcWarps][1024]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 8 + i) * 128 + e * 32 + lane] = acc[i][e];
  __syncthreads();
  for (int o = tid; o < 1024; o += T) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) v += red[w * 1024 + o];
    sums[o] = v;
  }
  cl.sync();  // every block's sums are in its shared memory
  const int share = (1024 + cluster - 1) / cluster;  // outputs whose epilogue it writes
  const int oend = min(1024, (rank + 1) * share);
  for (int o = rank * share + tid; o < oend; o += T) {
    // o = (i 4 + e) 32 + lane: column 16 (lane / 4) + 2 i + e / 2, row 2 (lane % 4) + e % 2
    const int ln = o & 31;
    const int i = o >> 7;
    const int e = (o >> 5) & 3;
    const int n = n0 + 16 * (ln >> 2) + 2 * i + (e >> 1);
    const int m = 2 * (ln & 3) + (e & 1);
    if (m >= a.M || n >= a.N) continue;
    int part[kTcMaxCluster], sq[kTcMaxCluster];  // the blocks' sums, loaded together
#pragma unroll
    for (int z = 0; z < kTcMaxCluster; ++z) {
      part[z] = z < cluster ? cl.map_shared_rank(sums, z)[o] : 0;
      sq[z] = z < cluster ? cl.map_shared_rank(rsum, z)[m] : 0;
    }
    int total = 0, sumq = 0;
#pragma unroll
    for (int z = 0; z < kTcMaxCluster; ++z) {
      total += part[z];
      sumq += sq[z];
    }
    w8a8_store(a, (size_t)m * a.N + n, n, total, sumq, rsx[m]);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// The rule of the tensor-core GEMV: 1 to 8 rows, N % 16 == 0 (16-byte loads
// of 16 columns), K % 32 == 0 (whole steps), x and the weight 16-byte aligned
// (cp.async), and a split of K into `cluster` (1 to 8) slices of split_rows
// (a multiple of 32, at most kTcXCap) that covers K with no slice empty. The
// other M <= 8 calls keep the dp4a body. Mirrored by w8a8_gemv_route and
// w8a8_gemv_split in qtpu_torch/kernels/int8_matmul.py.
bool w8a8_gemv_tc_fits(const W8A8Args& a, int cluster) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int slice = a.split_rows;
  if (a.M < 1 || a.M > kGemvRows || a.N % 16 != 0 || a.K % kW8TcK != 0) return false;
  if (cluster < 1 || cluster > kTcMaxCluster || slice < kW8TcK || slice % kW8TcK != 0 ||
      slice > kTcXCap || (long long)slice * cluster < a.K ||
      (long long)slice * (cluster - 1) >= a.K)
    return false;
  return aligned(a.x) && aligned(a.data);
}

int launch_w8a8_gemv_tc(const W8A8Args& a, int cluster, cudaStream_t st) {
  static bool smem_set = false;  // this kernel's record, in this library
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_gemv_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w8tc_smem(kTcXCap));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int strips = (a.N + kTcCols - 1) / kTcCols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(strips * cluster));
  cfg.blockDim = dim3(kW8TcThreads);
  cfg.dynamicSmemBytes = w8tc_smem(a.split_rows);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, w8a8_gemv_tc_kernel, a, cluster);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the Hopper route

using qtpu::encode_2d;
using qtpu::mbar_expect_tx;
using qtpu::mbar_init;
using qtpu::mbar_wait;
using qtpu::sm_count;
using qtpu::smem_u32;
using qtpu::tma_load_2d;
using qtpu::warp_arrive;
using qtpu::wg_desc;
using qtpu::wg_fence_u32;

constexpr int kQgBM = 128;            // x rows a tile: the N of each warpgroup's wgmma
constexpr int kQgBN = 128;            // output columns a tile: two consumer warpgroups of 64
constexpr int kQgBK = 128;            // K values a stage: one 128-byte swizzled row of xq
constexpr int kQgThreads = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kQgXS = kQgBM * kQgBK;  // bytes of xq a stage
constexpr int kQgWS = kQgBK * kQgBN;  // bytes of the weight a stage
constexpr int kQgRing = 6;
// align slack, the ring's xq and weight slots, then its full and empty barriers
constexpr int kQgSmem = 1024 + kQgRing * (kQgXS + kQgWS) + kQgRing * 2 * 8;
static_assert(kQgSmem <= 227 * 1024, "the ring fits a block's shared memory");
// setmaxnreg budget, as dq_wgmma.cuh's: 2 x 128 x 232 + 128 x 40 = 384 x 168
constexpr int kQgConsumerRegs = 232;
constexpr int kQgProducerRegs = 40;

// D[64 x 128] += A[64 x 32] B[32 x 128] in int32: A s8 from registers (the
// fragment layout of mma.sync m16n8k32's A for each warp's 16 rows), B s8
// K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_m64n128k32(int* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The thread's A fragments of the block's g-th stage, once its slot has
// landed, from the slot's weight tile wt ([128 K rows][128 columns] bytes,
// 128-byte swizzled by TMA: byte (k, n) at k 128 + ((n / 16) ^ (k % 8)) 16
// + n % 16). K step t (32 K values): a[t][0] holds column nc at K 32t + 4q
// .. + 3, a[t][1] column nc + 1 at the same K, a[t][2] and a[t][3] the same
// at K 32t + 16 + 4q (q = lane % 4). roff: the swizzled offsets of column nc
// in the thread's 4 rows of a 16-row block, in its load order; sel0, sel1:
// the byte_perm selectors that put its rows back in K order.
__device__ __forceinline__ void qg_fragments(const uint8_t* ws, uint64_t* full, int g,
                                             const uint32_t* roff, uint32_t sel0,
                                             uint32_t sel1, uint32_t (*a)[4]) {
  const int slot = g % kQgRing;
  mbar_wait(smem_u32(full + slot), (g / kQgRing) & 1);
  const uint8_t* wt = ws + slot * kQgWS;
#pragma unroll
  for (int h = 0; h < kQgBK / 16; ++h) {  // K rows 16 h + 4 q + {0, 1, 2, 3}
    uint32_t r[4];  // byte 0: column nc, byte 1: column nc + 1
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const unsigned short*>(wt + h * 16 * 128 + roff[i]);
    const uint32_t p01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t p23 = __byte_perm(r[2], r[3], 0x5140);
    a[h >> 1][(h & 1) * 2] = __byte_perm(p01, p23, sel0);
    a[h >> 1][(h & 1) * 2 + 1] = __byte_perm(p01, p23, sel1);
  }
}

// A block is persistent: it walks the 128 x 128 output tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... along M first (tile t is rows (t % ntm) 128,
// columns (t / ntm) 128), its producer running ahead across tile boundaries.
// Consumer warpgroup w computes outT rows n0 + 64 w .. + 63 (weight columns)
// by all 128 token rows, outT = dT xqT, with the weight tile as wgmma's A
// operand in registers and xq's tile, K-major as TMA lays it, as B.
__global__ void __launch_bounds__(kQgThreads, 1)
    w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                      const __grid_constant__ CUtensorMap tmw, W8A8Args a) {
  extern __shared__ uint8_t qg_smem[];  // aligned to 1024 by hand, as dq_wgmma_kernel's
  uint8_t* xs = qg_smem + ((1024 - (smem_u32(qg_smem) & 1023)) & 1023);
  uint8_t* ws = xs + kQgRing * kQgXS;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kQgRing * kQgWS);
  uint64_t* empty = full + kQgRing;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ntm = (a.M + kQgBM - 1) / kQgBM;
  const int ntiles = ntm * ((a.N + kQgBN - 1) / kQgBN);
  const int stages = (a.Kp + kQgBK - 1) / kQgBK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kQgRing; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, refilling a slot as
    // soon as the 8 consumer warps are done with its stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kQgProducerRegs));
    if (tid == 256) {
      int g = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int m0 = (tile % ntm) * kQgBM;
        const int n0 = (tile / ntm) * kQgBN;
        for (int s = 0; s < stages; ++s, ++g) {
          const int slot = g % kQgRing;
          if (g >= kQgRing) mbar_wait(smem_u32(empty + slot), (g / kQgRing - 1) & 1);
          const uint32_t bar = smem_u32(full + slot);
          mbar_expect_tx(bar, kQgXS + kQgWS);
          tma_load_2d(smem_u32(xs + slot * kQgXS), &tmx, bar, s * kQgBK, m0);
          tma_load_2d(smem_u32(ws + slot * kQgWS), &tmw, bar, n0, s * kQgBK);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: each loads the next stage's A fragments
    // while its wgmma runs; the two warpgroups' wgmmas interleave on the
    // tensor cores
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kQgConsumerRegs));
    const int lane = tid & 31;
    const int q = lane & 3;
    // the thread's weight columns nc, nc + 1 (its warp's A rows lane / 4 and
    // lane / 4 + 8); lanes q = 2, 3 load their rows 4q + {2, 3, 0, 1}, so the
    // 4 rows a warp loads at once lie in 4 swizzle chunks (16 banks)
    const int nc = wg * 64 + ((tid >> 5) & 3) * 16 + 2 * (lane >> 2);
    const int rot = (q >> 1) * 2;
    uint32_t roff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * q + ((i + rot) & 3);
      roff[i] = r * 128 + ((((nc >> 4) ^ r) & 7) << 4) + (nc & 15);
    }
    const uint32_t sel0 = rot ? 0x1054u : 0x5410u;  // bytes 0 (column nc) of rows 0-3
    const uint32_t sel1 = rot ? 0x3276u : 0x7632u;  // bytes 1 (column nc + 1)
    int acc[64];
    uint32_t afr[2][kQgBK / 32][4];
    int g = 0;            // the block's stages so far (ring slot and barrier phase)
    bool staged = false;  // afr[0] holds this tile's first fragments already
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = (tile % ntm) * kQgBM;
      const int n0 = (tile / ntm) * kQgBN;
      const int next = tile + gridDim.x;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0;
      if (!staged) qg_fragments(ws, full, g, roff, sel0, sel1, afr[0]);
      staged = false;
      // two stages an iteration, so each one's fragment buffer is a constant
      // index (a register array indexed at run time would live in local memory)
      for (int s0 = 0; s0 < stages; s0 += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = s0 + h;
          if (s >= stages) break;
          const int slot = (g + s) % kQgRing;
          const uint32_t xa = smem_u32(xs + slot * kQgXS);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int t = 0; t < kQgBK / 32; ++t)
            wgmma_s8_m64n128k32(acc, afr[h][t], wg_desc(xa + t * 32));
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the next stage's fragments while this one runs on the tensor
          // cores: this tile's, or the next tile's first when the stage
          // count is even (its buffer, afr[0], is then free)
          if (s + 1 < stages) {
            qg_fragments(ws, full, g + s + 1, roff, sel0, sel1, afr[h ^ 1]);
          } else if (h == 1 && next < ntiles) {
            qg_fragments(ws, full, g + s + 1, roff, sel0, sel1, afr[0]);
            staged = true;
          }
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          wg_fence_u32<64>(reinterpret_cast<uint32_t*>(acc));
          wg_fence_u32<kQgBK / 32 * 4>(&afr[h][0][0]);
          warp_arrive(smem_u32(empty + slot));
        }
      }
      g += stages;
      // outT fragment: rows lane / 4 and lane / 4 + 8 (columns nc, nc + 1),
      // columns (token rows) 8 jm + 2 q + {0, 1}; w8a8_out's arithmetic
      if (n0 + nc < a.N) {  // N % 16 == 0: nc + 1 too
        const int col = n0 + nc;
        const float sc0 = __bfloat162float(a.scales[col]);
        const float sc1 = __bfloat162float(a.scales[col + 1]);
        const int z0 = 128 - (int)a.zeros[col];
        const int z1 = 128 - (int)a.zeros[col + 1];
#pragma unroll
        for (int jm = 0; jm < 16; ++jm) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + 8 * jm + 2 * q + e;
            if (row < a.M) {
              const int sq = a.sumq[row];
              const float sx = a.sx[row];
              const int t0 = acc[4 * jm + e] + sq * z0;
              const int t1 = acc[4 * jm + 2 + e] + sq * z1;
              if (a.out_total != nullptr)
                *reinterpret_cast<int2*>(a.out_total + (size_t)row * a.N + col) =
                    make_int2(t0, t1);
              else
                *reinterpret_cast<__nv_bfloat162*>(a.out + (size_t)row * a.N + col) =
                    __halves2bfloat162(__float2bfloat16(((float)t0 * sc0) * sx),
                                       __float2bfloat16(((float)t1 * sc1) * sx));
            }
          }
        }
      }
    }
  }
}

// The route rule: more than 8 rows, N % 16 == 0 (TMA strides the weight's
// N-byte rows) and the weight and its scales 16-byte aligned; the other
// M > 8 calls keep w8a8_mma_kernel. Mirrored by w8a8_route in
// qtpu_torch/kernels/int8_matmul.py.
bool w8a8_wgmma_fits(const W8A8Args& a) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return a.M > kGemvRows && a.N % 16 == 0 && aligned(a.data) && aligned(a.scales);
}

// xq's map ([M, Kp] bytes, 128 x 128 boxes) and the weight's ([K, N] bytes,
// 128 x 128 boxes), both with the 128-byte swizzle, encoded per call; then
// the persistent grid. Returns a cudaError_t, or 0x10000 | CUresult for a
// failed encode (tma.cuh).
int launch_w8a8_wgmma(const W8A8Args& a, cudaStream_t st) {
  static bool smem_set = false;
  CUtensorMap tmx, tmw;
  int rc = encode_2d(&tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.xq, a.Kp, a.M, a.Kp, kQgBK, kQgBM,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  rc = encode_2d(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.data, a.N, a.K, a.N, kQgBN, kQgBK,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        w8a8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kQgSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int tiles = ((a.M + kQgBM - 1) / kQgBM) * ((a.N + kQgBN - 1) / kQgBN);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  w8a8_wgmma_kernel<<<tiles < sms ? tiles : sms, kQgThreads, kQgSmem, st>>>(tmx, tmw, a);
  return (int)cudaGetLastError();
}

W8A8Args w8a8_args(const void* x, const void* data, const void* scales, const void* zeros,
                   void* out, void* xq, void* sx, void* sumq, const void* amax, int M, int K,
                   int N) {
  W8A8Args a{};
  a.amax_in = static_cast<const float*>(amax);
  if (amax != nullptr) a.out_total = static_cast<int*>(out);
  else a.out = static_cast<__nv_bfloat16*>(out);
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.data = static_cast<const int8_t*>(data);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.zeros = static_cast<const uint8_t*>(zeros);
  a.xq = static_cast<int8_t*>(xq);
  a.sx = static_cast<float*>(sx);
  a.sumq = static_cast<int*>(sumq);
  a.M = M;
  a.K = K;
  a.Kp = (K + kBK - 1) / kBK * kBK;
  a.N = N;
  return a;
}

// The mma.sync body at M > 8: grid (N / 64, M / 128).
int launch_w8a8_mma(const W8A8Args& a, cudaStream_t st) {
  dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  w8a8_mma_kernel<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// y[M, N] = W8A8(x[M, K], data[K, N], scales[N], zeros[N]) on `stream`;
// amax: nullptr (x's own per-token absmax, out bf16 y), or f32 [M], each
// token's |x| max to quantize with (absmax in: a tensor-parallel rank's K
// slice), and then out is int32 [M, N], acc + Σxq (128 - z) before the
// rescale (the group sums it, then qtpu_w8a8_epilogue rescales).
// cluster > 0 (M <= 8): the tensor-core GEMV in one launch, K split over a
// thread-block cluster of `cluster` blocks of split_rows K rows each
// (w8a8_gemv_tc_fits must hold; no scratch is read). Otherwise xq: int8
// scratch [M, Kp], Kp = K rounded up to 64; sx: f32 [M]; sumq: int32 [M];
// for M <= 8 the dp4a body, split_rows (a multiple of 4, M * split_rows <=
// 32768) the K rows of one block slice, K for no split, and with more than
// one slice `part` an int32 scratch of slices * M * N. M > 8 takes the
// Hopper route where w8a8_wgmma_fits holds, else the mma.sync body. Returns
// a cudaError_t (0 on success; 0x10000 | CUresult for a tensor map the
// driver refused), or -1 for arguments the kernels do not take.
extern "C" int qtpu_w8a8_matmul(const void* x, const void* data, const void* scales,
                                const void* zeros, void* out, void* xq, void* sx, void* sumq,
                                void* part, const void* amax, int split_rows, int cluster,
                                int M, int K, int N, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0) return -1;
  W8A8Args a = w8a8_args(x, data, scales, zeros, out, xq, sx, sumq, amax, M, K, N);
  a.split_rows = split_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0)
    return w8a8_gemv_tc_fits(a, cluster) ? launch_w8a8_gemv_tc(a, cluster, st) : -1;
  if (M <= kGemvRows &&
      (split_rows <= 0 || split_rows % 4 != 0 || M * (split_rows / 4) > kGemvSmem))
    return -1;
  const int splits = M <= kGemvRows ? (K + split_rows - 1) / split_rows : 1;
  if (splits > 1 && part == nullptr) return -1;
  w8a8_quant_kernel<<<M, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (M > kGemvRows) return w8a8_wgmma_fits(a) ? launch_w8a8_wgmma(a, st) : launch_w8a8_mma(a, st);
  a.part = splits > 1 ? static_cast<int*>(part) : nullptr;
  dim3 grid((N + kGemvCols - 1) / kGemvCols, splits);
  w8a8_gemv_kernel<<<grid, kGemvThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + kThreads - 1) / kThreads < 1024 ? (mn + kThreads - 1) / kThreads : 1024);
  w8a8_finish_kernel<<<blocks, kThreads, 0, st>>>(a, splits);
  return (int)cudaGetLastError();
}

// qtpu_w8a8_matmul on the mma.sync body at M > 8, whatever the route rule
// says: the earlier body, kept so that the same bytes can be timed on both.
extern "C" int qtpu_w8a8_matmul_mma(const void* x, const void* data, const void* scales,
                                    const void* zeros, void* out, void* xq, void* sx, void* sumq,
                                    const void* amax, int M, int K, int N, void* stream) {
  if (M <= kGemvRows || K <= 0 || N <= 0 || K % 4 != 0 || N % 4 != 0) return -1;
  const W8A8Args a = w8a8_args(x, data, scales, zeros, out, xq, sx, sumq, amax, M, K, N);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  w8a8_quant_kernel<<<M, kThreads, 0, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_w8a8_mma(a, st);
}

// The absmax-out mode: amax[m] = max_k |x[m, k]| (f32) of x[M, K] on
// `stream`, one block a row of w8a8_quant_kernel, nothing else written.
extern "C" int qtpu_w8a8_absmax(const void* x, void* amax, int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return -1;
  W8A8Args a = w8a8_args(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, M, K, 0);
  a.amax_out = static_cast<float*>(amax);
  w8a8_quant_kernel<<<M, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The rescale of the absmax-in mode's int32 sums, once the group has summed them:
// out[m, n] = bf16((float(total[m, n]) s[n]) sx[m]), sx from the
// (all-reduced) absmax as the quantize kernel takes it: w8a8_y's arithmetic,
// so the bits are one rank's whole product's.
__global__ void __launch_bounds__(kThreads) w8a8_epilogue_kernel(const int* total,
                                                                 const float* amax,
                                                                 const __nv_bfloat16* scales,
                                                                 __nv_bfloat16* out, int M,
                                                                 int N) {
  const size_t mn = (size_t)M * N;
  for (size_t o = blockIdx.x * (size_t)kThreads + threadIdx.x; o < mn;
       o += (size_t)gridDim.x * kThreads) {
    const int m = (int)(o / N);
    const float sx = fmaxf(__fmul_rn(amax[m], 1.0f / 127.0f), 1e-8f);
    out[o] = __float2bfloat16(((float)total[o] * __bfloat162float(scales[o % N])) * sx);
  }
}

extern "C" int qtpu_w8a8_epilogue(const void* total, const void* amax, const void* scales,
                                  void* out, int M, int N, void* stream) {
  if (M <= 0 || N <= 0) return -1;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + kThreads - 1) / kThreads < 1024 ? (mn + kThreads - 1) / kThreads
                                                                  : 1024);
  w8a8_epilogue_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(total), static_cast<const float*>(amax),
      static_cast<const __nv_bfloat16*>(scales), static_cast<__nv_bfloat16*>(out), M, N);
  return (int)cudaGetLastError();
}
