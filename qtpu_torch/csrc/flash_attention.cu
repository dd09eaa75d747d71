// K5: causal (optionally sliding-window) GQA flash attention for the
// full-sequence forward (perplexity eval, prefill without a cache).
//
// Replaces the TPU kernel pallas_flash_attention
// (qtpu/kernels/pallas_flash_attention.py:86) and computes what it computes:
// q [B, H, S, hd], k/v [B, KV, S, hd] bf16; q head h reads KV head
// h / (H / KV) in place (no repeat in memory); scores in f32, scaled by
// 1/sqrt(hd) in f32 (together with log2(e), see Design); key k attends to query q when k <= q and, with
// window > 0, k > q - window; -1e30 is the masked score and the initial
// running max; the online-softmax recurrence (m, l, acc) in f32; the
// l == 0 guard on the normaliser; output in bf16.
//
// Bound on an H100: operations. At the eval shape (B 1, H 32, KV 4,
// S 2048, hd 64) the causal half of QK^T and PV is 17.2 GFLOP against
// 18.9 MB of q/k/v/o, about 900 FLOP per byte, three times the card's
// ratio. So the products go to the tensor cores: mma.sync m16n8k16 bf16 ->
// f32, the instruction K1's prefill path uses.
//
// Design. A block of 4 warps owns 64 query rows of one (batch, q head),
// 16 rows per warp; its Q fragments stay in registers for the whole key
// loop. Key tiles of 64 rows of K and V go through two shared-memory
// buffers with cp.async, so the next tile loads while this one is
// computed; both stay in their natural [key][d] layout (rows padded by 16
// bytes, so ldmatrix reads them without bank conflicts), and ldmatrix gives
// the B fragments of S = Q K^T directly and those of O += P V through its
// transposing form. Scores and the output accumulate in f32 registers; P is
// rounded to bf16 for the PV product (within 2e-2 of the f32 math). Scores
// are kept in the log2 domain (scaled by log2(e) / sqrt(hd) in one multiply),
// so each probability is one exp2. Row max and sum are f32 registers,
// reduced over the 4 lanes that share a row. The key loop starts at the
// window's first tile and stops at the diagonal, so a block does only the
// causal (or banded) work; only tiles that cross the diagonal or the window's
// edge are masked; the last query blocks, which do the most, are scheduled
// first. Rows and keys past S are masked in the kernel (zero-filled loads,
// no stores), so any S works. Strided q/k/v/o are read in place (element
// strides for batch, head and position; the head dim must be contiguous),
// so the caller's [B, S, H, hd] projections need no copy.
//
// Head dims: any multiple of 8 from 8 to 256 (qtpu's kernel takes any hd;
// Falcon3's published configs use 256). The mma.sync body is written in
// k-steps of 16 and 8-column tiles, so each hd is an instance of it: at hd %
// 16 == 8 the last k-step's upper 8 columns are zero in q's fragment and in
// K's (the row's 8-column pad, zeroed in registers), and the last P V pair
// of tiles drops the pad's.
//
// The Hopper body (flash_wgmma_kernel, the one calls take where
// flash_wgmma_fits holds: q, k and v 16-byte aligned with strides of whole
// 16-byte units). mma.sync reaches a fraction of the card's bf16 rate; only
// wgmma reaches it. The body follows K1's route (dq_wgmma.cuh, tma.cuh):
//  * a block owns 128 query rows of one (batch, q head), two consumer
//    warpgroups of 64 rows each, and a producer warpgroup whose one thread
//    loads Q once and keeps the K and V tiles of 128 keys (64 above hd
//    128) in flight by TMA
//    (4D tensor maps over the strided [B, H|KV, S, hd] views, the 128-byte
//    swizzle, 64 head-dim columns a box) in a ring of 2 (hd > 64) or 3
//    (hd <= 64) stages, refilled as soon as both warpgroups release a stage
//    (an mbarrier of 8 warp arrivals); setmaxnreg gives the consumers 232
//    registers and the producer 40, as on the route;
//  * an hd that is not a multiple of 64 is held in the tile of the next
//    multiple, HP = 64 to 256: the tensor maps' inner dimension is the true
//    hd (a row of hd * 2 bytes, a multiple of 16 at every hd % 8 == 0), so
//    TMA fills the columns past it with zeros and reads no byte more from
//    memory; S = Q K^T runs ceil(hd / 16) k-steps (at hd % 16 == 8 the last
//    one's upper half is those zeros), P V runs at N = HP (wgmma's MN-major
//    128-byte swizzled B operand comes in 64-column atoms: N 128 over each
//    pair of chunks, N 64 over a last odd one), and only the true columns of
//    O are rescaled and stored. At hd 80 that is 128 / 80 = 1.6x the PV
//    products and (80 + 128) / 160 = 1.3x the tensor-core work of the
//    bound; the scale is 1 / sqrt(hd) of the true hd;
//  * above hd 128 (three or four chunks) a K / V tile is 64 keys (FaLayout::
//    BK): Q's 64 KB and a 2-stage ring of 128-key tiles would not fit in
//    shared memory, and O's 128 accumulators a thread at hd 256 leave room
//    for S's 32, not 64;
//  * S = Q K^T is wgmma m64n128k16 (m64n64k16 on 64-key tiles) with both
//    operands in shared memory,
//    K-major as TMA lays them (wg_desc); the scores are in the accumulator
//    layout of mma.sync's C, so the online softmax (log2 domain, the mask
//    only on tiles that cross the diagonal or the window's edge, -1e30, f32
//    m and l, the l == 0 guard) is the mma.sync body's, row max and sum over
//    the 4 lanes of a row, exp2 on the special function unit; the two
//    warpgroups take turns to issue S (two named barriers), so that one's
//    softmax runs while the other's products occupy the tensor cores;
//  * O += P V is wgmma m64n{hd}k16 with P as register A fragments (S's
//    accumulator of two 8-key blocks is P's A fragment of 16 keys, rounded
//    to bf16) and V read through a descriptor of the MN-major (transposed)
//    128-byte swizzled layout: V stays [key][d] as TMA writes it;
//  * the tile range (the window's first tile to the diagonal), the longest
//    query blocks first, ragged S (TMA zero-fills boxes past S; the stores
//    are masked) are the mma.sync body's.
// qtpu_flash_attention_mma keeps the mma.sync body reachable for any call it
// takes, for comparison on the same bytes; no eval path calls it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "head_dims.cuh"
#include "tma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FlashArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;  // element strides: batch, head, position
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int S, G, window;  // G = H / KV
  float scale_log2;  // log2(e) / sqrt(hd)
};

template <int HD>
constexpr int smem_bytes() {
  return 4 * kBK * (HD + 8) * 2;  // K and V, two buffers each, padded rows
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// mma.sync m16n8k16 fragments, lane = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, by column):  b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C (16 x 8, f32):        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// A C fragment of S over two adjacent 8-key tiles is the A fragment of P
// over those 16 keys, so P never leaves registers. For S the B operand is
// K[key][d]: ldmatrix of the 8 x 8 block (keys n*8.., d kk*16..) gives b0
// and the block at d + 8 gives b1. For PV it is V[key][d]: the transposing
// ldmatrix of the block (keys kk*16.., d n*8..) gives b0, keys + 8 give b1.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(FlashArgs a) {
  constexpr int LD = HD + 8;      // padded row of a K or V tile, in bf16
  constexpr int TILE = kBK * LD;  // one buffer
  constexpr int KST = (HD + 15) / 16;  // k-steps of Q K^T (the last half empty at hd % 16 == 8)
  constexpr int NS = kBK / 8;     // 8-key tiles of S
  constexpr int NO = HD / 8;      // 8-column tiles of O
  constexpr int CH = HD / 8;      // 16-byte chunks per K/V row
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* ks = smem;             // [2][kBK][LD]
  __nv_bfloat16* vs = smem + 2 * TILE;  // [2][kBK][LD]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int lr = lane % 8;  // ldmatrix: the row this lane addresses
  const int lm = lane / 8;  // ldmatrix: the matrix of that row
  const int qblk = gridDim.x - 1 - blockIdx.x;  // the longest key loops first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qblk * kBQ;
  const __nv_bfloat16* qp = a.q + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = a.k + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vp = a.v + b * a.v_sb + kvh * a.v_sh;
  const int row0 = q0 + warp * 16 + g;  // query row of c0/c1; row0 + 8 of c2/c3

  const int last_q = min(q0 + kBQ, a.S) - 1;
  const int kt_end = last_q / kBK;
  const int kt_begin = a.window > 0 ? max(q0 - a.window + 1, 0) / kBK : 0;

  auto load_tile = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH;
      const int c = (i % CH) * 8;
      const bool ok = k0 + r < a.S;
      const long long key = ok ? k0 + r : 0;
      cp_async16(ks + buf * TILE + r * LD + c, kp + key * a.k_ss + c, ok);
      cp_async16(vs + buf * TILE + r * LD + c, vp + key * a.v_ss + c, ok);
    }
    cp_async_commit();
  };
  load_tile(kt_begin, 0);

  uint32_t qf[KST][4];
#pragma unroll
  for (int kk = 0; kk < KST; ++kk) {
    const int col = kk * 16 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const __nv_bfloat16* src = qp + (long long)row * a.q_ss + col;
      qf[kk][r] = row < a.S ? ld_pair(src) : 0u;
      qf[kk][r + 2] = row < a.S && col + 8 < HD ? ld_pair(src + 8) : 0u;
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt < kt_end) {
      load_tile(kt + 1, buf ^ 1);  // that buffer was consumed one step ago
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt is in buffer buf
    const __nv_bfloat16* kb = ks + buf * TILE;
    const __nv_bfloat16* vb = vs + buf * TILE;
    const int k0 = kt * kBK;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KST; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, kb + (n * 8 + (lm / 2) * 8 + lr) * LD + kk * 16 + (lm % 2) * 8);
        if (HD % 16 != 0 && kk == KST - 1) bf[1] = bf[3] = 0u;  // the row's pad, past hd
        mma_bf16(s[n], qf[kk], bf);
        mma_bf16(s[n + 1], qf[kk], bf + 2);
      }
    }

    // a tile needs the mask where it crosses the diagonal or the window's
    // edge for some row of the block (keys past S lie past the diagonal)
    const bool masked = k0 + kBK - 1 > q0 || (a.window > 0 && k0 <= q0 + kBQ - 1 - a.window);
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale_log2;
        if (masked) {
          const int row = row0 + (e >= 2 ? 8 : 0);
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          if (key > row || (a.window > 0 && key <= row - a.window)) x = kMasked;
        }
        s[n][e] = x;
        mn[e >> 1] = fmaxf(mn[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
      alpha[r] = exp2f(m[r] - mn[r]);
      m[r] = mn[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mn[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vb + (kk * 16 + (lm % 2) * 8 + lr) * LD + (n + lm / 2) * 8);
        mma_bf16(o[n], pa, bf);
        if (n + 1 < NO) mma_bf16(o[n + 1], pa, bf + 2);  // else the row's pad
      }
    }
    __syncthreads();  // buffer buf is consumed before the next load into it
  }

  __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
    const float inv = 1.0f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(op + (long long)row * a.o_ss + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ------------------------------------------------------ the Hopper body

constexpr int kWBQ = 128;  // query rows a block: two consumer warpgroups of 64
constexpr int kWBK = 128;  // keys a tile
constexpr int kWThreads = 384;
constexpr int kWConsumerRegs = 232;
constexpr int kWProducerRegs = 40;

template <int HD>
struct FaLayout {
  static constexpr int NC = (HD + 63) / 64;   // 64-column (128-byte) chunks of a row
  static constexpr int HP = 64 * NC;          // the padded head dim: P V's N
  // keys a tile: 128, or 64 above hd 128 (three or four chunks: 128-key
  // tiles would outgrow shared memory, and S's 64 accumulators beside O's
  // 96-128 the consumers' registers)
  static constexpr int BK = NC > 2 ? 64 : kWBK;
  static constexpr int QB = NC * kWBQ * 128;  // Q tile
  static constexpr int TB = NC * BK * 128;    // a K or V tile
  static constexpr int RING = NC == 1 ? 3 : 2;
  static constexpr int SMEM = 1024 + QB + RING * 2 * TB + 8 * (1 + 2 * RING);
};

// A tensor map's coordinate order: the head dim first, then the position,
// head and batch dimensions sorted by stride (pos_* give each one's place).
struct FaMaps {
  int pos_s, pos_h, pos_b;
};

__device__ __forceinline__ void fa_tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the rows from `row` of head h, batch b, columns c0 .. c0 + 63, in the map's order
__device__ __forceinline__ void fa_load(uint32_t dst, const CUtensorMap* map, const FaMaps& o,
                                        uint32_t bar, int c0, int row, int h, int b) {
  int c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = i == o.pos_s ? row : (i == o.pos_h ? h : b);
  fa_tma_load_4d(dst, map, bar, c0, c[0], c[1], c[2]);
}

// wgmma descriptor of an MN-major operand in 128-byte swizzled rows (V as
// B of P V: rows are keys, 128 bytes of 64 d each): 8-row groups 1024 bytes
// apart (SBO), 64-column chunks `lbo` bytes apart (LBO), layout 1
__device__ __forceinline__ uint64_t fa_desc_mn(uint32_t saddr, uint32_t lbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fa_wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, " "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void fa_wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, " "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void fa_wgmma_rs_n64_t(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, " "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void fa_wgmma_rs_n128_t(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, " "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// S = Q K^T of one k-step over a tile of BK keys
template <int BK>
__device__ __forceinline__ void fa_qk(float* s, uint64_t da, uint64_t db, int acc) {
  if constexpr (BK == 64) fa_wgmma_ss_n64(s, da, db, acc);
  else fa_wgmma_ss_n128(s, da, db, acc);
}

// O += P V of 16 keys at row `key` of a V tile of BK keys in NC 64-column
// chunks: N 128 over each pair of chunks, N 64 over a last odd one (O's
// accumulators of chunk c start at 32 c)
template <int NC, int BK>
__device__ __forceinline__ void fa_pv(float* o, const uint32_t* p, uint32_t vb, int key) {
#pragma unroll
  for (int c = 0; c < NC; c += 2) {
    const uint64_t db = fa_desc_mn(vb + c * BK * 128 + key * 128, BK * 128);
    if (c + 1 < NC) fa_wgmma_rs_n128_t(o + 32 * c, p, db, 1);
    else fa_wgmma_rs_n64_t(o + 32 * c, p, db, 1);
  }
}

// exp2 on the special function unit (denormal results flushed to 0)
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barriers of 256 threads (two warpgroups): the consumers take turns
// to issue S = Q K^T, so one warpgroup's softmax runs under the other's products
__device__ __forceinline__ void fa_bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void fa_bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

template <int N>
__device__ __forceinline__ void fa_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// grid (ceil(S / 128), H, B), block 384 (consumer warpgroups 0 and 1,
// producer warpgroup 2), FaLayout<HD>::SMEM bytes of dynamic shared memory.
template <int HD>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv, FaMaps qo, FaMaps ko,
                       FlashArgs a) {
  using L = FaLayout<HD>;
  extern __shared__ uint8_t fa_smem[];  // aligned to 1024 by hand (an __align__ here would move
                                        // the dynamic shared memory of the mma.sync body)
  uint8_t* qs = fa_smem + ((1024 - (qtpu::smem_u32(fa_smem) & 1023)) & 1023);
  uint8_t* ks = qs + L::QB;              // [RING][NC][BK keys][128 B]
  uint8_t* vs = ks + L::RING * L::TB;    // the same for V
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + L::RING * L::TB);
  uint64_t* qbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::RING;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int qblk = gridDim.x - 1 - blockIdx.x;  // the longest key loops first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int q0 = qblk * kWBQ;
  const int last_q = min(q0 + kWBQ, a.S) - 1;
  const int kt_end = last_q / L::BK;
  const int kt_begin = a.window > 0 ? max(q0 - a.window + 1, 0) / L::BK : 0;

  if (tid == 0) {
    qtpu::mbar_init(qtpu::smem_u32(qbar), 1);
#pragma unroll
    for (int i = 0; i < L::RING; ++i) {
      qtpu::mbar_init(qtpu::smem_u32(full + i), 1);
      qtpu::mbar_init(qtpu::smem_u32(empty + i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q once, then K and V tile by tile into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProducerRegs));
    if (tid == 256) {
      const uint32_t qb = qtpu::smem_u32(qbar);
      qtpu::mbar_expect_tx(qb, L::QB);
#pragma unroll
      for (int c = 0; c < L::NC; ++c)
        fa_load(qtpu::smem_u32(qs + c * kWBQ * 128), &tmq, qo, qb, 64 * c, q0, h, b);
      for (int kt = kt_begin; kt <= kt_end; ++kt) {
        const int i = kt - kt_begin;
        const int slot = i % L::RING;
        if (i >= L::RING) qtpu::mbar_wait(qtpu::smem_u32(empty + slot), (i / L::RING - 1) & 1);
        const uint32_t fb = qtpu::smem_u32(full + slot);
        qtpu::mbar_expect_tx(fb, 2 * L::TB);
#pragma unroll
        for (int c = 0; c < L::NC; ++c) {
          fa_load(qtpu::smem_u32(ks + slot * L::TB + c * L::BK * 128), &tmk, ko, fb, 64 * c,
                  kt * L::BK, kvh, b);
          fa_load(qtpu::smem_u32(vs + slot * L::TB + c * L::BK * 128), &tmv, ko, fb, 64 * c,
                  kt * L::BK, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsumerRegs));
  const int lane = tid & 31;
  const int t = lane & 3;
  const int q0w = q0 + 64 * wg;
  const int row0 = q0w + 16 * ((tid >> 5) & 3) + (lane >> 2);  // c0/c1's row; row0 + 8: c2/c3's
  float o[L::HP / 2];  // columns past hd stay unused
#pragma unroll
  for (int i = 0; i < L::HP / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  const uint32_t qa = qtpu::smem_u32(qs) + wg * 64 * 128;
  qtpu::mbar_wait(qtpu::smem_u32(qbar), 0);
  if (wg == 1) fa_bar_arrive(1);  // warpgroup 0 issues its first product first

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int i = kt - kt_begin;
    const int slot = i % L::RING;
    qtpu::mbar_wait(qtpu::smem_u32(full + slot), (i / L::RING) & 1);
    const uint32_t kb = qtpu::smem_u32(ks + slot * L::TB);
    const uint32_t vb = qtpu::smem_u32(vs + slot * L::TB);
    const int k0 = kt * L::BK;

    float s[L::BK / 2];  // no initial value: the first product ignores it (scale-d 0)
    fa_bar_sync(1 + wg);  // this warpgroup's turn on the tensor cores
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // (hd + 15) / 16 k-steps: at hd % 16 == 8 the last one's upper 8
    // columns are TMA's zeros in both Q and K
#pragma unroll
    for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::BK * 128 + (kk % 4) * 32;
      fa_qk<L::BK>(s, qtpu::wg_desc(qa + (kk / 4) * kWBQ * 128 + (kk % 4) * 32),
                   qtpu::wg_desc(kb + off), kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the other warpgroup's turn (warpgroup 1 owes none after its last tile:
    // each barrier completes as often as it is waited on)
    if (wg == 0 || kt < kt_end) fa_bar_arrive(2 - wg);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fa_fence<L::BK / 2>(s);

    // the mask where the tile crosses the diagonal or the window's edge for
    // a row of this warpgroup (keys past S lie past the diagonal): those
    // tiles are scaled into the log2 domain and masked here; the others stay
    // raw, their maximum scaled once (the scale is positive) and each
    // probability one FFMA and one exp2. Row maxima in two partial chains each.
    const bool masked = k0 + L::BK - 1 > q0w || (a.window > 0 && k0 <= q0w + 63 - a.window);
    float sc = a.scale_log2;
    if (masked) {
#pragma unroll
      for (int j = 0; j < L::BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >= 2 ? 8 : 0);
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const float x = s[4 * j + e] * sc;
          s[4 * j + e] =
              key > row || (a.window > 0 && key <= row - a.window) ? kMasked : x;
        }
      }
      sc = 1.f;
    }
    float mx[2][2] = {{kMasked, kMasked}, {kMasked, kMasked}};
#pragma unroll
    for (int j = 0; j < L::BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[j & 1][e >> 1] = fmaxf(mx[j & 1][e >> 1], s[4 * j + e]);
    float mn[2], nmn[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(mx[0][r], mx[1][r]);
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 1));
      mn[r] = fmaxf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], 2));
      mn[r] = fmaxf(m[r], mn[r] * sc);
      alpha[r] = fa_exp2(m[r] - mn[r]);
      m[r] = mn[r];
      nmn[r] = -mn[r];
    }
    uint32_t pf[L::BK / 16][4];
    float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // the tile's row sums, two partial chains
#pragma unroll
    for (int j = 0; j < L::BK / 8; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = fa_exp2(fmaf(s[4 * j + e], sc, nmn[e >> 1]));
        ls[j & 1][e >> 1] += pv[e];
      }
      // keys 8j .. 8j + 7 are half of P's A fragment of keys 16 (j / 2) ..
      pf[j / 2][2 * (j & 1)] = pack_bf16(pv[0], pv[1]);
      pf[j / 2][2 * (j & 1) + 1] = pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (ls[0][r] + ls[1][r]);
    // the output rescaled where a row's maximum moved (any lane of the warp)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk) fa_pv<L::NC, L::BK>(o, pf[kk], vb, 16 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fa_fence<L::HP / 2>(o);
    qtpu::wg_fence_u32<L::BK / 4>(&pf[0][0]);
    qtpu::warp_arrive(qtpu::smem_u32(empty + slot));  // K and V of the stage are consumed
  }

  __nv_bfloat16* op = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
    const float inv = 1.0f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(op + (long long)row * a.o_ss + 8 * j + 2 * t) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// The 4D map of a [B, heads, S, hd] view with element strides (sb, sh, ss)
// (the head dim contiguous), boxes of 64 columns x `rows` positions, the
// 128-byte swizzle; its dimensions after the head dim are sorted by stride.
int fa_map(CUtensorMap* map, FaMaps* order, const void* base, int B, int heads, int S, int hd,
           long long sb, long long sh, long long ss, int rows) {
  const qtpu::TmapEncodeFn enc = qtpu::tmap_encoder();
  if (enc == nullptr) return qtpu::kWgEncodeError | 0xffff;
  long long dim[3] = {S, heads, B}, str[3] = {ss, sh, sb};
  int box[3] = {rows, 1, 1}, idx[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)  // sort by stride
    for (int j = i + 1; j < 3; ++j)
      if (str[idx[j]] < str[idx[i]]) {
        const int tmp = idx[i];
        idx[i] = idx[j];
        idx[j] = tmp;
      }
  cuuint64_t dims[4] = {(cuuint64_t)hd, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t boxes[4] = {64, 0, 0, 0};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[1 + i] = (cuuint64_t)dim[idx[i]];
    strides[i] = (cuuint64_t)str[idx[i]] * 2;
    boxes[1 + i] = (cuuint32_t)box[idx[i]];
    if (idx[i] == 0) order->pos_s = i;
    if (idx[i] == 1) order->pos_h = i;
    if (idx[i] == 2) order->pos_b = i;
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (qtpu::kWgEncodeError | (int)r);
}

// The head dims both bodies take: multiples of 8 from 8 to 256.
bool head_dim_ok(int hd) { return hd % 8 == 0 && hd >= 8 && hd <= 256; }

// The Hopper body's rule: q, k and v 16-byte aligned with strides of whole
// 16-byte units below 2^39 elements (TMA's), at a head dim head_dim_ok
// takes. Mirrored by flash_route in qtpu_torch/kernels/flash_attention.py.
bool flash_wgmma_fits(const void* q, const void* k, const void* v, const long long* strides9,
                      int hd) {
  if (!head_dim_ok(hd) || !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16))
    return false;
  for (int i = 0; i < 9; ++i)
    if (strides9[i] % 8 != 0 || strides9[i] <= 0 || strides9[i] >= (1LL << 39)) return false;
  return true;
}

template <int HD>
int launch_flash_wgmma(const void* q, const void* k, const void* v, const FlashArgs& a, int B,
                       int H, int KV, cudaStream_t st) {
  using L = FaLayout<HD>;
  static bool smem_set = false;
  CUtensorMap tmq, tmk, tmv;
  FaMaps qo{}, ko{}, vo{};
  int rc = fa_map(&tmq, &qo, q, B, H, a.S, HD, a.q_sb, a.q_sh, a.q_ss, kWBQ);
  if (rc == 0) rc = fa_map(&tmk, &ko, k, B, KV, a.S, HD, a.k_sb, a.k_sh, a.k_ss, L::BK);
  if (rc == 0) rc = fa_map(&tmv, &vo, v, B, KV, a.S, HD, a.v_sb, a.v_sh, a.v_ss, L::BK);
  if (rc != 0) return rc;
  if (ko.pos_s != vo.pos_s || ko.pos_h != vo.pos_h || ko.pos_b != vo.pos_b) return -1;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((a.S + kWBQ - 1) / kWBQ, H, B);
  flash_wgmma_kernel<HD><<<grid, kWThreads, L::SMEM, st>>>(tmq, tmk, tmv, qo, ko, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_flash_mma(const FlashArgs& a, int B, int H, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD>();
  static bool smem_set = false;
  if (smem > 48 * 1024 && !smem_set) {  // above the 48 KB a block gets without asking
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((a.S + kBQ - 1) / kBQ, H, B);
  flash_attn_kernel<HD><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_flash(const void* q, const void* k, const void* v, const FlashArgs& a, int B, int H,
                 int KV, bool wgmma, cudaStream_t st) {
  return wgmma ? launch_flash_wgmma<HD>(q, k, v, a, B, H, KV, st)
               : launch_flash_mma<HD>(a, B, H, st);
}

// The mma.sync body, or the Hopper body (wgmma: the caller has checked
// flash_wgmma_fits), on the arguments qtpu_flash_attention takes.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, long long o_ss,
                    int B, int H, int KV, int S, int hd, int window, bool wgmma, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || !head_dim_ok(hd) || B > 65535 ||
      H > 65535)
    return -1;
  if (!aligned(k, 16) || !aligned(v, 16) || !aligned(q, 4) || !aligned(o, 4)) return -1;
  const long long kv_strides[6] = {k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (long long s : kv_strides)
    if (s % 8 != 0) return -1;
  const long long qo_strides[6] = {q_sb, q_sh, q_ss, o_sb, o_sh, o_ss};
  for (long long s : qo_strides)
    if (s % 2 != 0) return -1;
  FlashArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.S = S;
  a.G = H / KV;
  a.window = window;
  a.scale_log2 = kLog2e / sqrtf((float)hd);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define QTPU_FA_CASE(HD) \
  case HD: return launch_flash<HD>(q, k, v, a, B, H, KV, wgmma, st);
    QTPU_HEAD_DIMS(QTPU_FA_CASE)
#undef QTPU_FA_CASE
    default: return -1;
  }
}

}  // namespace

// o = attention(q, k, v) with the strides given in elements (the head dim
// is contiguous in all four; hd a multiple of 8 from 8 to 256). q/o need
// even strides and 4-byte alignment;
// k/v strides that are multiples of 8 and 16-byte alignment (16-byte row
// loads). The Hopper body runs where flash_wgmma_fits holds (q too 16-byte
// aligned with strides that are multiples of 8), the mma.sync body
// elsewhere. Returns a cudaError_t (0 on success), or -1 for arguments the
// kernel does not take; an encode error of a tensor map as 0x10000 | CUresult.
extern "C" int qtpu_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KV, int S, int hd, int window, void* stream) {
  const long long s9[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const bool wgmma = flash_wgmma_fits(q, k, v, s9, hd);
  return flash_attention(q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                         o_sb, o_sh, o_ss, B, H, KV, S, hd, window, wgmma, stream);
}

// qtpu_flash_attention on the mma.sync body whatever the rule says: the
// earlier body on the same bytes, for comparison. Same arguments.
extern "C" int qtpu_flash_attention_mma(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KV, int S, int hd, int window, void* stream) {
  return flash_attention(q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                         o_sb, o_sh, o_ss, B, H, KV, S, hd, window, false, stream);
}

