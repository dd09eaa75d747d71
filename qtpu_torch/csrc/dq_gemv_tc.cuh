// The decode GEMV (M <= 8) of K1 (dequant_matmul.cu), K7
// (codebook_matmul.cu), K4 (fused_mlp.cu, both phases) and K9
// (moe_matmul.cu) on Hopper's tensor cores: one launch a call, the weight
// streamed by 16-byte cp.async into a per-lane shared-memory ring, the
// products on mma.sync m16n8k16 (bf16 in, f32 out), K split over a
// thread-block cluster merged through distributed shared memory. Its block
// body, gtc_block, also runs the matmul phases of K13 (layer_boundary.cu),
// one call a tile between that kernel's grid barriers, and K10's gathered
// slots (moe_matmul.cu), through a row map.
//
// Computes what dq_core.cuh's dq_tile computes (its note gives the layout
// and the MODEs), y = sum over groups c of s_c o (x_c @ B_c), with B_c the
// exact integer codes minus the zero point (q - z, exact in bf16) or, in the
// codebook mode, the level rounded to bf16 (as dq_wgmma.cuh's route rounds
// it), each group's f32 product scaled by its f32 scale before it joins the
// f32 sum. MODE 0 plain, 1 the SwiGLU pair of K4's phase A (rms-norm
// prologue, silu(gate) and up rounded to bf16 where dq_core rounds them), 2
// the residual (K4's phase B, K1's resid), 3 the codebook (K7), 4 and 6 K1's
// norm_w and both options.
//
// Bound on an H100: the packed bytes (W4: K N / 2 and the group scales and
// zeros; Mixtral's expert site 235 MB, 70 µs at 3.35 TB/s). dq_tile spends
// 8 f32 FMAs on every weight (one a row of x, x read from shared memory),
// about 25 instructions a weight byte at W4, more than the f32 lanes issue
// at the memory's rate. Here one mma.sync multiplies a 16-column x 16-K tile
// of the weight by all 8 rows of x: per weight byte a lane spends about 3
// instructions to make the A fragments and 1/4 of an mma.
//
// Design. A block owns 128 output columns (of one expert, K9) and one slice
// of K; its warps (4 a column set; K4's pair has two sets, gate and up)
// split the slice in steps of 16 K values. The mma's A operand is the
// weight (16 rows = 16 columns, in an order of our choosing), B is x (8
// columns = the 8 rows of x), so a step is 8 mmas over the warp's 128
// columns, and the K order inside a step is chosen to follow the bytes:
//  * a lane (g = lane / 4, t = lane % 4) reads 16 columns, 16 g .. 16 g + 15,
//    of its packed rows with one 16-byte load each: at W4 rows p and p + 1
//    (p = the step's first row + 2 t), at W8 rows p, p + 1, p + 8, p + 9; a
//    warp's load is 4 rows x 128 contiguous bytes, and its mma i takes the
//    lane's columns 2 i and 2 i + 1 as A rows g and g + 8;
//  * at W4, byte b of row p holds K index k_p (low nibble) and k_p + g / 2
//    (excess-8 high nibble, qtpu/core/packing.py:36-62); byte_perm pairs the
//    two rows' bytes of a column so that (P & 0x000F000F) | 0x43004300 is the
//    bf16 pair (128 + q_p, 128 + q_p+1) of the low nibbles and the same on
//    P >> 4 (^ 0x43084308) of the high ones; one bf16x2 subtraction of
//    128 + z makes them exact q - z (dq_wgmma.cuh's trick). The A fragment's
//    K indices are then (k_p, k_p + 1) and (k_p + g/2, k_p + g/2 + 1), so its
//    B fragment is two 32-bit loads of x, each two adjacent K values;
//  * the codebook reads a 256-entry table in shared memory (both levels of
//    a code byte as bf16, 32 copies so a warp's lookups never share a bank);
//    W8 makes each byte the f32 2^23 + (q ^ 128) and subtracts 2^23 + z;
//  * the weight goes by cp.async (16 bytes, L1 bypassed) into a ring of
//    RING steps a lane in shared memory that only the lane reads, so a step
//    needs no barrier: RING - 1 steps are in flight (W4: 4 x 32 bytes a lane,
//    64 KB an SM at 4 blocks); a group's 16 zeros and 16 scales of the lane
//    come in the same cp.async group as the group's first step (two header
//    slots, by the group's parity);
//  * x (8 rows of the block's K slice, rows >= M zero) is staged once in
//    shared memory by cp.async, under the ring's first loads, as bf16 with a
//    padded row pitch (conflict-free B loads); the norm modes first compute
//    each row's rms over all of K and stage h = bf16(x / rms * nw) as
//    dq_core rounds it; with a row map (RMAP, K10) row m of the block is
//    row map[m] of x and of the output;
//  * each group's 8 mma tiles land in a fresh f32 accumulator, which the
//    group's f32 scale (two a lane a tile: its two columns) folds into the
//    f32 sum at the group's end;
//  * the warps' sums meet in shared memory; a cluster of C blocks (the K
//    slices of one column strip, C from the wrapper's rule, gemv_split in
//    qtpu_torch/kernels/dequant_matmul.py) adds its blocks' sums through
//    distributed shared memory, each block the epilogue of 1/C of the
//    strip's outputs: one launch, no split-K scratch, no second launch;
//  * which body runs is gemv_tc_fits below (mirror: gemv_route), on the
//    shape, the group, the bits and the alignment; the other M <= 8 calls
//    keep dq_core's GEMV.
// Everything here has internal linkage (an anonymous namespace), so each
// library that includes it keeps its own kernels and launch records; K6's
// decode GEMV (w8a8_matmul.cu) uses its cp.async helpers.
#pragma once

#include <cooperative_groups.h>

#include "dq_core.cuh"

namespace qtpu {
namespace {

constexpr int kTcCols = 128;   // output columns a block (a warp's step covers them all)
constexpr int kTcWarps = 4;    // warps a column set
constexpr int kTcXCap = 4096;  // K values of x a block stages (8 rows, 64 KB)
constexpr int kTcMaxCluster = 8;

template <int BITS, int MODE>
struct TcLayout {
  static constexpr int NSET = Mode<MODE>::kSets;
  static constexpr int THREADS = 32 * kTcWarps * NSET;
  static constexpr int RPL = BITS == 4 ? 2 : 4;   // 16-byte packed rows a lane reads a step
  static constexpr int RING = BITS == 4 ? 5 : 4;  // steps a lane's ring holds
  static constexpr int RING_BYTES = RING * RPL * 16 * THREADS;
  static constexpr int RED_BYTES = kTcWarps * NSET * 1024 * 4;  // the warps' sums, after the ring
  static constexpr int A_BYTES = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static constexpr int HDR_BYTES = 2 * 3 * 16 * THREADS;  // zeros and scales, two groups
  static constexpr int SUM_BYTES = NSET * 1024 * 4;       // the block's sums (the cluster's)
  static constexpr int TAB_BYTES = MODE == 3 ? 256 * 32 * 4 : 0;
  static constexpr int FIXED = 16 + A_BYTES + HDR_BYTES + SUM_BYTES + 64 + TAB_BYTES;
  static int smem(int kslice) { return FIXED + 8 * (kslice + 8) * 2; }
};

struct TcArgs {
  int E;             // experts (K9), else 1
  int cluster;       // blocks a column strip: the K slices
  int slice_groups;  // groups a K slice
  long long x_es, w_es, s_es, o_es;  // strides between experts (x_es 0: a shared x)
};

__device__ __forceinline__ uint32_t gtc_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void gtc_cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void gtc_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void gtc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void gtc_mma(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t gtc_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// W8: the bf16 pair (q0 - z, q1 - z) of bytes q0, q1 (int8 + 128 after ^ 0x80)
__device__ __forceinline__ uint32_t gtc_w8_pair(uint32_t q0, uint32_t q1, float zf) {
  const float v0 = __uint_as_float(0x4B000000u | ((q0 & 0xFFu) ^ 0x80u)) - zf;
  const float v1 = __uint_as_float(0x4B000000u | ((q1 & 0xFFu) ^ 0x80u)) - zf;
  const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The 8 mmas of one step: w[RPL] the lane's packed rows (16 columns each),
// b0/b1 its B fragment, zw[4] the zeros of its 16 columns (a byte each),
// tab the lane's copy of the codebook table. Column c's zero becomes the
// bf16 pair 128 + z (W4: byte_perm of [z, 0x43, z, 0x43]) or the f32
// 2^23 + z (W8: [z, 0, 0, 0x4B]) where an mma needs it.
template <int BITS, int MODE>
__device__ __forceinline__ void gtc_step(const uint4* w, uint32_t b0, uint32_t b1,
                                         const uint32_t* zw, const uint32_t* tab,
                                         float (*grp)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int wi = i >> 1;
    // the zeros of columns 2i and 2i + 1: bytes (2i) % 4 and (2i + 1) % 4 of word i / 2
    const uint32_t b = 2 * (i & 1);
    uint32_t zz0 = 0, zz1 = 0;
    float zf0 = 0.f, zf1 = 0.f;
    if constexpr (MODE != 3 && BITS == 4) {
      zz0 = __byte_perm(zw[wi], 0x43u, b | 0x4040u | (b << 8));
      zz1 = __byte_perm(zw[wi], 0x43u, (b + 1) | 0x4040u | ((b + 1) << 8));
    } else if constexpr (MODE != 3) {
      zf0 = __uint_as_float(__byte_perm(zw[wi], 0x4B000000u, b | 0x7440u));
      zf1 = __uint_as_float(__byte_perm(zw[wi], 0x4B000000u, (b + 1) | 0x7440u));
    }
    uint32_t a0, a1, a2, a3;
    if constexpr (BITS == 4) {
      const uint32_t ra = reinterpret_cast<const uint32_t*>(&w[0])[wi];
      const uint32_t rb = reinterpret_cast<const uint32_t*>(&w[1])[wi];
      if constexpr (MODE == 3) {
        // bytes of columns 2i (row p, row p + 1) and 2i + 1
        const int sh = (i & 1) * 16;
        const uint32_t ta = tab[32 * ((ra >> sh) & 0xFFu)];
        const uint32_t tb = tab[32 * ((rb >> sh) & 0xFFu)];
        const uint32_t tc = tab[32 * ((ra >> (sh + 8)) & 0xFFu)];
        const uint32_t td = tab[32 * ((rb >> (sh + 8)) & 0xFFu)];
        a0 = __byte_perm(ta, tb, 0x5410);  // low nibbles' levels: K k_p, k_p + 1
        a2 = __byte_perm(ta, tb, 0x7632);  // high nibbles': K k_p + g/2, + 1
        a1 = __byte_perm(tc, td, 0x5410);
        a3 = __byte_perm(tc, td, 0x7632);
      } else {
        // P = [row p col 2i, row p col 2i+1, row p+1 col 2i, row p+1 col 2i+1]
        const uint32_t P = __byte_perm(ra, rb, (i & 1) ? 0x7632 : 0x5410);
        a0 = gtc_sub((P & 0x000F000Fu) | 0x43004300u, zz0);
        a2 = gtc_sub(((P >> 4) & 0x000F000Fu) ^ 0x43084308u, zz0);
        a1 = gtc_sub(((P >> 8) & 0x000F000Fu) | 0x43004300u, zz1);
        a3 = gtc_sub(((P >> 12) & 0x000F000Fu) ^ 0x43084308u, zz1);
      }
    } else {  // W8: rows p, p + 1 (A's K 2t, 2t + 1) and p + 8, p + 9 (2t + 8, 2t + 9)
      const int sh = (i & 1) * 16;
      const uint32_t r0 = reinterpret_cast<const uint32_t*>(&w[0])[wi] >> sh;
      const uint32_t r1 = reinterpret_cast<const uint32_t*>(&w[1])[wi] >> sh;
      const uint32_t r8 = reinterpret_cast<const uint32_t*>(&w[2])[wi] >> sh;
      const uint32_t r9 = reinterpret_cast<const uint32_t*>(&w[3])[wi] >> sh;
      a0 = gtc_w8_pair(r0, r1, zf0);
      a1 = gtc_w8_pair(r0 >> 8, r1 >> 8, zf1);
      a2 = gtc_w8_pair(r8, r9, zf0);
      a3 = gtc_w8_pair(r8 >> 8, r9 >> 8, zf1);
    }
    gtc_mma(grp[i], a0, a1, a2, a3, b0, b1);
  }
}

// Where gtc_block leaves the block's sums, from the base of its shared memory.
template <int BITS, int MODE>
__device__ __forceinline__ float* gtc_sums(uint8_t* base) {
  return reinterpret_cast<float*>(base + TcLayout<BITS, MODE>::A_BYTES +
                                  TcLayout<BITS, MODE>::HDR_BYTES);
}

// One block's share of a call: the kTcCols output columns from n0 (of the
// packed rows' column set, K4's pair: both sets) over the K slice [kbase,
// kbase + ksl) of whole groups, x's slice staged with a row pitch of `pitch`
// bf16 (at least ksl + 8). On return the block's f32 sums (NSET x 1024, the
// warps' layout: see the epilogue below) are in TcLayout's `sums`, not yet
// visible to the other threads (the caller synchronizes). The cluster kernel
// below runs one per block; K13's phases (layer_boundary.cu) run one per
// tile of a grid-barrier phase, so a block's shared memory is reused from one
// call to the next once every thread is past the caller's barrier.
// RMAP: row m of the block is row rmap[m] of x (K10's slots of one expert;
// shared memory, a.M entries); otherwise row m.
template <int BITS, int MODE, bool RMAP = false>
__device__ __forceinline__ void gtc_block(const DqArgs& a, int n0, int kbase, int ksl, int pitch,
                                          uint8_t* base, const int* rmap = nullptr) {
  static_assert(!RMAP || !Mode<MODE>::kNorm, "the norm modes stage x by row index");
  using L = TcLayout<BITS, MODE>;
  constexpr int PK = 8 / BITS;
  constexpr int T = L::THREADS;
  uint8_t* ring = base;                             // [RING][RPL][T] uint4, then the warps' sums
  uint8_t* hdr = ring + L::A_BYTES;                 // [2][3][T] uint4: zeros, scales (2)
  float* sums = gtc_sums<BITS, MODE>(base);         // [NSET][1024]
  float* inv_rms = sums + L::NSET * 1024;           // [8]
  uint32_t* tab = reinterpret_cast<uint32_t*>(inv_rms + 16);   // MODE 3: [256][32]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<uint8_t*>(tab) +
                                                       L::TAB_BYTES);  // [8][pitch]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int set = warp / kTcWarps;
  const int wis = warp % kTcWarps;
  const int lg = lane >> 2;
  const int lt = lane & 3;
  const int col = n0 + 16 * lg;        // the lane's first column
  const bool in = col < a.N;           // N % 16 == 0: all 16 columns or none
  const int wcol = set * a.N + col;    // its column in the packed rows (K4's pair: up at N)
  const int g = a.group;
  const int spg = g / 16;              // steps a group
  const int nsteps = ksl / 16;
  const int per = (nsteps + kTcWarps - 1) / kTcWarps;
  const int ws = min(nsteps, wis * per);
  const int we = min(nsteps, ws + per);

  // ---- the weight's ring: step s of the block's slice into slot (s - ws) % RING
  auto issue = [&](int s, int slot) {
    const int sg = kbase / 16 + s;  // the step among all of K
    const int c = sg / spg;
    const int j = sg - c * spg;
    int row;
    if constexpr (BITS == 4) row = c * (g / PK) + 8 * j + 2 * lt;
    else row = c * g + 16 * j + 2 * lt;
    const int8_t* src = a.data + (size_t)row * a.ldw + wcol;
    const uint32_t dst = gtc_smem_u32(ring) + (uint32_t)(slot * L::RPL * T + tid) * 16;
#pragma unroll
    for (int r = 0; r < L::RPL; ++r) {
      const int dr = BITS == 4 ? r : (r & 1) + 8 * (r >> 1);  // W8: rows p, p+1, p+8, p+9
      gtc_cp16(dst + r * T * 16, in ? src + (size_t)dr * a.ldw : a.data, in);
    }
    if (s == ws || j == 0) {  // the group's zeros and scales, by its parity
      const uint32_t h = gtc_smem_u32(hdr) + (uint32_t)((c & 1) * 3 * T + tid) * 16;
      const __nv_bfloat16* sp = a.scales + (size_t)c * a.ldw + wcol;
      if (MODE != 3 && a.zeros != nullptr)
        gtc_cp16(h, in ? a.zeros + (size_t)c * a.ldw + wcol : a.zeros, in);
      gtc_cp16(h + T * 16, in ? sp : a.scales, in);
      gtc_cp16(h + 2 * T * 16, in ? sp + 8 : a.scales, in);
    }
  };
  // ---- x of the slice into shared memory by cp.async (its own group, first),
  // while the ring's first steps load; the norm modes stage h below instead
  if constexpr (!Mode<MODE>::kNorm) {
    const int chunks = ksl / 8;  // 16-byte chunks a row
    for (int i = tid; i < 8 * chunks; i += T) {
      const int m = i / chunks;
      const int k = 8 * (i - m * chunks);
      const bool ok = m < a.M;
      if constexpr (RMAP)
        gtc_cp16(gtc_smem_u32(xs + m * pitch + k),
                 ok ? a.x + (size_t)rmap[m] * a.K + kbase + k : a.x, ok);
      else
        gtc_cp16(gtc_smem_u32(xs + m * pitch + k), ok ? a.x + (size_t)m * a.K + kbase + k : a.x,
                 ok);
    }
    gtc_commit();
  }
#pragma unroll
  for (int p = 0; p < L::RING - 1; ++p) {
    if (ws + p < we) issue(ws + p, p);
    gtc_commit();
  }

  // ---- the norm modes: h = bf16(rms_norm(x) * nw) of the slice, the rms
  // over all of K, as dq_core rounds it
  if constexpr (Mode<MODE>::kNorm) {
    for (int m = warp; m < 8; m += T / 32) {
      float ss = 0.f;
      if (m < a.M) {
        const uint2* xr = reinterpret_cast<const uint2*>(a.x + (size_t)m * a.K);
#pragma unroll 8
        for (int k = lane; k < a.K / 4; k += 32) {
          const uint2 v = __ldg(xr + k);
          const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
          const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
          ss += f0.x * f0.x + f0.y * f0.y + f1.x * f1.x + f1.y * f1.y;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) inv_rms[m] = 1.0f / sqrtf(ss / (float)a.K + a.eps);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < 8 * (ksl / 4); i += T) {
      const int m = i / (ksl / 4);
      const int k = 4 * (i - m * (ksl / 4));
      uint2 v = make_uint2(0u, 0u);
      if (m < a.M) {
        v = __ldg(reinterpret_cast<const uint2*>(a.x + (size_t)m * a.K + kbase + k));
        const uint2 wr = __ldg(reinterpret_cast<const uint2*>(a.nw + kbase + k));
        const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(&v);
        const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&wr);
        __nv_bfloat16 h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = __float2bfloat16(bf2f(xb[e]) * inv_rms[m] * bf2f(wb[e]));
        v = *reinterpret_cast<const uint2*>(h);
      }
      *reinterpret_cast<uint2*>(xs + m * pitch + k) = v;
    }
  }
  if constexpr (MODE == 3) {  // code byte b's two levels (low nibble, excess-8 high), 32 copies
    for (int b = tid; b < 256; b += T) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(__ldg(a.cb + (b & 15)),
                                                      __ldg(a.cb + ((b >> 4) ^ 8)));
      const uint32_t v = *reinterpret_cast<const uint32_t*>(&v2);
#pragma unroll
      for (int l = 0; l < 32; l += 4)
        *reinterpret_cast<uint4*>(tab + 32 * b + l) = make_uint4(v, v, v, v);
    }
  }
  if constexpr (!Mode<MODE>::kNorm) gtc_wait<L::RING - 1>();  // x's group (not the ring's)
  __syncthreads();

  // ---- the warp's steps
  float acc[8][4], grp[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = grp[i][e] = 0.f;
  uint32_t zw[4] = {0u, 0u, 0u, 0u};  // the group's zeros of the lane's 16 columns
  uint32_t sc[8];  // the group's scales, bf16 pairs of columns (2i, 2i + 1)
  const uint32_t* ltab = tab + lane;
  const __nv_bfloat16* xrow = xs + lg * pitch;  // B's column: row lg of x
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sc[i]));
      acc[i][0] = fmaf(s.x, grp[i][0], acc[i][0]);
      acc[i][1] = fmaf(s.x, grp[i][1], acc[i][1]);
      acc[i][2] = fmaf(s.y, grp[i][2], acc[i][2]);
      acc[i][3] = fmaf(s.y, grp[i][3], acc[i][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) grp[i][e] = 0.f;
    }
  };
  for (int s = ws; s < we; ++s) {
    const int it = s - ws;
    gtc_wait<L::RING - 2>();  // step s's copies (and its header) have landed
    uint4 w[L::RPL];
#pragma unroll
    for (int r = 0; r < L::RPL; ++r)
      w[r] = *reinterpret_cast<const uint4*>(ring + ((it % L::RING) * L::RPL * T + r * T + tid) * 16);
    const int sg = kbase / 16 + s;
    const int c = sg / spg;
    const int j = sg - c * spg;
    if (s == ws || j == 0) {
      if (s != ws) flush();
      const uint4* h = reinterpret_cast<const uint4*>(hdr) + (c & 1) * 3 * T + tid;
      const uint4 s0 = h[T], s1 = h[2 * T];
      sc[0] = s0.x; sc[1] = s0.y; sc[2] = s0.z; sc[3] = s0.w;
      sc[4] = s1.x; sc[5] = s1.y; sc[6] = s1.z; sc[7] = s1.w;
      if constexpr (MODE != 3) {
        if (a.zeros != nullptr) {
          const uint4 z4 = h[0];
          zw[0] = z4.x; zw[1] = z4.y; zw[2] = z4.z; zw[3] = z4.w;
        } else {  // symmetric: z = 2^(BITS - 1) in every byte
          zw[0] = zw[1] = zw[2] = zw[3] = (1u << (BITS - 1)) * 0x01010101u;
        }
      }
    }
    // refill the slot step s - 1 used, RING - 1 steps ahead
    if (s + L::RING - 1 < we) issue(s + L::RING - 1, (it + L::RING - 1) % L::RING);
    gtc_commit();
    // B: x[lg][k0, k0 + 1] and x[lg][k1, k1 + 1], the step's K pairs of lane t
    int k0, k1;
    if constexpr (BITS == 4) {
      k0 = c * g + 8 * j + 2 * lt;
      k1 = k0 + g / 2;
    } else {
      k0 = c * g + 16 * j + 2 * lt;
      k1 = k0 + 8;
    }
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xrow + k0 - kbase);
    const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xrow + k1 - kbase);
    gtc_step<BITS, MODE>(w, b0, b1, zw, ltab, grp);
  }
  if (we > ws) flush();
  gtc_wait<0>();

  // ---- the warps' sums, the block's
  __syncthreads();  // every warp is done with the ring (the sums reuse it)
  float* red = reinterpret_cast<float*>(ring);  // [NSET][kTcWarps][1024]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[(warp * 8 + i) * 128 + e * 32 + lane] = acc[i][e];
  __syncthreads();
  for (int idx = tid; idx < L::NSET * 1024; idx += T) {
    const int st = idx >> 10;
    const int o = idx & 1023;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) v += red[(st * kTcWarps + w) * 1024 + o];
    sums[idx] = v;
  }
}

// grid (cluster x column strips, E), cluster (cluster, 1, 1), block
// TcLayout::THREADS; dynamic shared memory TcLayout::smem(slice of K).
template <int BITS, int MODE, bool EXPERTS>
__global__ void __launch_bounds__(TcLayout<BITS, MODE>::THREADS, 512 / TcLayout<BITS, MODE>::THREADS)
    dq_gemv_tc_kernel(DqArgs a, TcArgs t) {
  using L = TcLayout<BITS, MODE>;
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t gtc_smem[];  // aligned to 16 by hand (an __align__ here would move
                                         // the dynamic shared memory of every kernel in the file)
  uint8_t* base = gtc_smem + ((16 - (gtc_smem_u32(gtc_smem) & 15)) & 15);
  float* sums = gtc_sums<BITS, MODE>(base);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int strip = blockIdx.x / t.cluster;
  if constexpr (EXPERTS) {
    const int e = blockIdx.y;
    a.x += (size_t)e * t.x_es;
    a.data += (size_t)e * t.w_es;
    a.scales += (size_t)e * t.s_es;
    if (a.zeros != nullptr) a.zeros += (size_t)e * t.s_es;
    a.out += (size_t)e * t.o_es;
  }
  const int tid = threadIdx.x;
  const int n0 = strip * kTcCols;
  const int groups = a.K / a.group;
  const int gb = rank * t.slice_groups;
  const int ge = min(groups, gb + t.slice_groups);
  const int ksl = ge > gb ? (ge - gb) * a.group : 0;  // the block's K values
  gtc_block<BITS, MODE>(a, n0, gb * a.group, ksl, t.slice_groups * a.group + 8, base);
  cluster.sync();  // every block's sums are in its shared memory
  const int share = (1024 + t.cluster - 1) / t.cluster;  // outputs whose epilogue it writes
  const int oend = min(1024, (rank + 1) * share);
  for (int o = rank * share + tid; tid < 128 && o < oend; o += 128) {
    float v[L::NSET];
#pragma unroll
    for (int st = 0; st < L::NSET; ++st) {
      float part[kTcMaxCluster];  // the blocks' sums, loaded together
#pragma unroll
      for (int z = 0; z < kTcMaxCluster; ++z)
        part[z] = z < t.cluster ? cluster.map_shared_rank(sums, z)[st * 1024 + o] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int z = 0; z < kTcMaxCluster; ++z) sum += part[z];
      v[st] = sum;
    }
    // o = (i * 4 + e) * 32 + lane of the warps' layout: column 16 (lane / 4) + 2 i + e / 2,
    // row 2 (lane % 4) + e % 2
    const int ln = o & 31;
    const int i = o >> 7;
    const int e = (o >> 5) & 3;
    const int n = n0 + 16 * (ln >> 2) + 2 * i + (e >> 1);
    const int m = 2 * (ln & 3) + (e & 1);
    if (m < a.M && n < a.N) {
      const size_t oi = (size_t)m * a.N + n;
      a.out[oi] = epilogue<MODE>(v, a, oi);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The rule: the tensor-core GEMV takes an M <= 8 call at W4 or W8, group 64
// or 128, N % 16 == 0 and a row pitch ldw % 16 == 0 (16-byte loads of 16
// columns), the codes, scales, zeros and x 16-byte aligned (x 8-byte with
// norm_w), and a
// split of K into `cluster` (1 to 8) slices of slice_groups whole
// groups each that covers every group once with x's slice at most kTcXCap
// values. Mirrored by gemv_route / gemv_split in
// qtpu_torch/kernels/dequant_matmul.py.
bool gemv_tc_fits(const DqArgs& a, int bits, int cluster, int slice_groups) {
  auto al = [](const void* p, int b) { return reinterpret_cast<uintptr_t>(p) % b == 0; };
  if (a.M < 1 || a.M > 8 || (bits != 4 && bits != 8) || (a.group != 64 && a.group != 128) ||
      a.N % 16 != 0 || a.ldw % 16 != 0 || a.K % a.group != 0)
    return false;
  const int groups = a.K / a.group;
  if (cluster < 1 || cluster > kTcMaxCluster) return false;
  if (slice_groups < 1 || (long long)slice_groups * cluster < groups ||
      (long long)slice_groups * (cluster - 1) >= groups || slice_groups * a.group > kTcXCap)
    return false;
  // x: 16-byte cp.async chunks, or 8-byte loads in the norm modes
  return al(a.x, a.nw != nullptr ? 8 : 16) && al(a.data, 16) && al(a.scales, 16) &&
         (a.zeros == nullptr || al(a.zeros, 16)) && (a.nw == nullptr || al(a.nw, 8));
}

// One launch of a kernel of this body (kernel(a, t, extra...)): grid
// (cluster x ceil(N / 128), y), cluster (t.cluster, 1, 1); smem_set: the
// kernel's record that its shared memory limit is raised, in this library.
template <int BITS, int MODE, typename Kernel, typename... Extra>
int launch_tc_cluster(Kernel kernel, bool& smem_set, const DqArgs& a, const TcArgs& t, int y,
                      cudaStream_t st, Extra... extra) {
  using L = TcLayout<BITS, MODE>;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               L::smem(kTcXCap));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const long long strips = (a.N + kTcCols - 1) / kTcCols;
  if (strips * t.cluster > 0x7fffffffLL || y < 1 || y > 65535) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(strips * t.cluster), (unsigned)y);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::smem(t.slice_groups * a.group);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, t, extra...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One launch of the body: grid (cluster x ceil(N / 128), E).
template <int BITS, int MODE, bool EXPERTS>
int launch_gemv_tc(const DqArgs& a, const TcArgs& t, cudaStream_t st) {
  static bool smem_set = false;  // this instance's record, in this library
  return launch_tc_cluster<BITS, MODE>(dq_gemv_tc_kernel<BITS, MODE, EXPERTS>, smem_set, a, t,
                                       t.E, st);
}

// K1, K7 and K4's phases (one expert): the body at BITS, MODE.
template <int MODE>
int gemv_tc(const DqArgs& a, int bits, int cluster, int slice_groups, cudaStream_t st) {
  if (!gemv_tc_fits(a, bits, cluster, slice_groups)) return -1;
  const TcArgs t{1, cluster, slice_groups, 0, 0, 0, 0};
  if (bits == 4) return launch_gemv_tc<4, MODE, false>(a, t, st);
  if constexpr (MODE == 3) return -1;  // codebook sites are W4: no W8 instance
  else return launch_gemv_tc<8, MODE, false>(a, t, st);
}

}  // namespace
}  // namespace qtpu
