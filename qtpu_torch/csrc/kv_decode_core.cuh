// The decode-attention core shared by K3's kernel (csrc/kv_attention.cu:
// K3, K8, K11 and the one-layer entry) and K12's split body
// (csrc/kv_flash_decode.cu): one block attends G query heads of one
// (sequence, kv-head) over one slice [s_beg, s_end) of its cache rows and
// leaves their unnormalized (m, l, acc) in shared memory.
//
// Bound: the bytes of the slice (int8 k and v codes and their two f32
// scales a row, or bf16 k and v). What the design does about it:
//  * an asynchronous ring of raw chunks: kRows rows of k and v at one byte a
//    code (two a value on the bf16 cache) plus the scales, filled by 16-byte
//    cp.async.cg copies (8-byte cp.async.ca where an int8 row is hd % 16 ==
//    8 bytes and so only 8-byte aligned; the scales by 4-byte cp.async.ca,
//    as a slice may start at any row), kStages stages: the first three
//    chunks are issued at once, then two are in flight while a third is
//    computed. Rows past the slice are zero-filled, never read;
//  * q . k and p . v on the tensor cores: mma.sync m16n8k16 bf16 -> f32.
//    A of q . k is the query rows of one m-tile (16 heads; rows past G
//    zero), loaded once into registers; B is the key codes converted
//    int8 -> bf16 in registers (exact for |c| <= 128: f32 magic 2^23 + c
//    through byte_perm, whose top half is the bf16). k_scale / sqrt(hd) is
//    applied to each score column after the product, in f32. A of p . v is
//    bf16(e * v_scale), the TPU kernel's rounding point
//    (pallas_kv_attention.py:118, :540, :764), straight from the score
//    fragment; B is the value codes as exact bf16. The bf16 cache (K8) loads
//    its fragments with ldmatrix and has no scales (A = bf16(e));
//  * each of the 4 warps keeps its own online softmax (m, l and the output
//    in f32 registers) over its own 16-row blocks of every chunk, so the
//    chunk loop has one barrier a chunk; the warps' states are merged once,
//    at the end, through the drained ring.
// The int8 fragments are read from shared memory without conversion passes:
// the head dimension of q . k is permuted (lane t of a quad owns hd / 4
// contiguous bytes of a key row, q's A fragment follows the same order), and
// the keys of a 16-row block are permuted (n-tile column j is key
// j / 2 + 4 (j % 2), +8 in the second n-tile), so that a lane's four value
// rows of p . v are rows t, t + 4, t + 8, t + 12 and its output columns lie
// in one contiguous run of hd / 8 bytes of each. Row pitches are padded so
// that these reads spread over the banks (k: hd + 16 bytes at hd % 32 == 0,
// hd + 32 at 48, 80, 112; v: hd + 32 but at hd 32 and 96).
//
// Head dims: any multiple of 8 from 8 to 256. A row's bytes are 64-byte
// blocks (4 k-steps, 16 bytes a lane) and a tail of hd % 64 bytes, hd % 64 / 4
// a lane: 1 to 4 k-steps of 4 bytes a lane, the last one's missing half
// (hd % 16 == 8: 2 bytes a lane) zero in q's A fragment (a bf16 row's
// missing 8 columns: zero in q and in B). A lane's run of hd / 8 value bytes
// starts 4-byte aligned when hd % 32 == 0; elsewhere 2 or 1 bytes in, and is
// read as whole words from the word below, shifted (load_run).
//
// Warps: a block's G <= 32 heads are MT = 1 or 2 m-tiles of 16 query rows;
// above hd 128 each head's output columns are split over CS = 2 warps (their
// n-tiles, so a warp holds at most 64 accumulators: both compute the same
// scores). The 4 warps are MT x CS units, each with 4 / (MT CS) warps over a
// chunk's key blocks. The kernels split a larger G over a grid axis (head
// groups of at most kMaxG heads, head_groups), each block re-reading the
// rows: a third and fourth m-tile in the block measured 4.8% slower at hd 64,
// G 8 (MT no longer 1 or 2 at compile time, PERF.md section 6).
//
// Shared memory a block (Layout::SMEM: the ring or the merge, whichever is
// larger): hd 64: 3 x 11.5 KB = 34.5 KB; hd 80: 3 x 13.5 KB = 40.5 KB; hd
// 128: 3 x 19.5 KB = 58.5 KB; hd 256: 3 x 35.5 KB = 106.5 KB; bf16 cache hd
// 64: 54 KB (K8), hd 256: 3 x 66 KB = 198 KB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "head_dims.cuh"

namespace kvd {
namespace {

constexpr int kRows = 64;    // cache rows a chunk
constexpr int kStages = 3;   // ring stages
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 32;    // query heads a block (head groups take more)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, bool BF>
struct Layout {
  static constexpr int ROW = BF ? 2 * HD : HD;  // bytes of a cache row
  // bytes a cp.async of a row: an int8 row of hd % 16 == 8 bytes is only
  // 8-byte aligned in the cache
  static constexpr int PIECE = ROW % 16 == 0 ? 16 : 8;
  static constexpr int RP = (ROW + 15) / 16 * 16;
  // k row pitch in the ring
  static constexpr int KLD = BF || HD % 32 == 0 ? RP + 16 : RP + 32;
  static constexpr int VLD = BF ? ROW + 16 : (HD == 32 || HD == 96 ? HD : RP + 32);
  static constexpr int V_OFF = kRows * KLD;
  static constexpr int KS_OFF = V_OFF + kRows * VLD;   // int8: k scales of the chunk
  static constexpr int VS_OFF = KS_OFF + (BF ? 0 : 4 * kRows);
  static constexpr int STAGE = VS_OFF + (BF ? 0 : 4 * kRows);
  static constexpr int RING = kStages * STAGE;
  // warps splitting a head's output columns, the n-tiles (8 columns) each holds
  static constexpr int CS = HD > 128 ? 2 : 1;
  static constexpr int NOW = (HD / 8 + CS - 1) / CS;
  // once the ring is drained: each warp's output [16][OLD] in fragment
  // order (rows padded so that its float2 stores spread over the banks),
  // m[16], l[16]; then the block's acc [kMaxG][HD], m[kMaxG], l[kMaxG]; then
  // each warp's weight in each head's merge [kMaxG][kWarps]
  static constexpr int OLD = 8 * NOW + 8;
  static constexpr int WARP_PART = 4 * (16 * OLD + 32);
  static constexpr int BLOCK_OFF = kWarps * WARP_PART;
  static constexpr int BLOCK_PART = 4 * (kMaxG * HD + 2 * kMaxG);
  static constexpr int WEIGHT_OFF = BLOCK_OFF + BLOCK_PART;
  static constexpr int MERGE = WEIGHT_OFF + 4 * kMaxG * kWarps;
  static constexpr int USED = RING > MERGE ? RING : MERGE;
  static constexpr int SMEM = USED + 16;  // + 16: the base is aligned by hand
};

// Blocks (head groups) a kernel splits the G heads of a kv-head over, and
// the heads of each but the last (ceil(G / groups) <= kMaxG).
__host__ __device__ constexpr int head_groups(int G) { return (G + kMaxG - 1) / kMaxG; }

__host__ __device__ constexpr int group_heads(int G) {
  return (G + head_groups(G) - 1) / head_groups(G);
}

__device__ __forceinline__ unsigned char* align16(void* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 15) &
                                          ~static_cast<uintptr_t>(15));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 8 : 0));
}

// PIECE (16 or 8) bytes global -> shared, asynchronously; zero-filled when !valid
template <int PIECE>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src, bool valid) {
  if constexpr (PIECE == 16) cp_async16(dst, src, valid);
  else cp_async8(dst, src, valid);
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// code byte E of a word already xor-ed with 0x80808080, as an exact f32
template <int E>
__device__ __forceinline__ float code(uint32_t ux) {
  return __uint_as_float(__byte_perm(ux, 0x4B000000u, 0x7440 + E)) - 8388736.f;  // 2^23 + 128
}

// two exact small integers in f32 as bf16x2 (their top halves), lo first
__device__ __forceinline__ uint32_t top_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The head-dim offset of byte j of k-step kk held by quad lane t (int8): a
// 64-byte block of a row gives each lane 16 contiguous bytes (4 k-steps), the
// trailing block of hd % 64 bytes a quarter of it (hd % 64 / 4 bytes, 2 to
// 14: 1 to 4 k-steps, the last one half empty where hd % 16 == 8).
template <int HD>
__device__ __forceinline__ int kdim(int kk, int t) {
  constexpr int FULL = 4 * (HD / 64);  // k-steps in full 64-byte blocks
  return kk < FULL ? 64 * (kk / 4) + 16 * t + 4 * (kk % 4)
                   : 64 * (HD / 64) + (HD % 64 / 4) * t + 4 * (kk - FULL);
}

// Whether the q pair `half` of k-step kk lies inside the row (int8 order):
// false only in the tail's last k-step where hd % 16 == 8.
template <int HD>
__device__ __forceinline__ constexpr bool kpair_in(int kk, int half) {
  constexpr int FULL = 4 * (HD / 64);
  return kk < FULL || 4 * (kk - FULL) + 2 * half < HD % 64 / 4;
}

// A cache row's bytes [off, off + N) into N / 4 words (N = 4, 8, 12 or 16)
template <int N>
__device__ __forceinline__ void load_words(uint32_t* w, const unsigned char* p) {
  if constexpr (N == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
}

// A lane's run of N bytes at p (A-byte aligned: 4, 2 or 1) into (N + 3) / 4
// words, byte i of the run at byte i % 4 of word i / 4 (the bytes past the run
// in the last word are whatever follows it in the row): whole words where p
// is 4-byte aligned; else the words from the one below p, shifted down by 8
// bits for each byte p lies past it (the run and its offset fit the words
// read: (4 - A + N + 3) / 4 of them).
template <int N, int A>
__device__ __forceinline__ void load_run(uint32_t* w, const unsigned char* p) {
  constexpr int RW = (N + 3) / 4;
  if constexpr (A == 4 && N % 4 == 0) {
    load_words<N>(w, p);
  } else if constexpr (A == 4) {
#pragma unroll
    for (int i = 0; i < RW; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  } else {
    constexpr int XW = (4 - A + N + 3) / 4;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    const uint32_t sh = A == 2 ? ((a & 2) ? 16u : 0u) : 8u * static_cast<uint32_t>(a & 3);
    uint32_t x[XW + 1];
#pragma unroll
    for (int i = 0; i < XW; ++i) x[i] = src[i];
    x[XW] = 0u;
#pragma unroll
    for (int i = 0; i < RW; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], sh);
  }
}

// The alignment (4, 2 or 1 bytes) of offsets that are multiples of n
__host__ __device__ constexpr int align_of(int n) { return n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1; }

// One (sequence, kv-head) of a cache layer: row 0's k and v (int8 codes or
// bf16 values) and scales (int8 only), and the row `fresh` (-1: none) that
// comes from fresh_k / fresh_v instead of the cache: global memory on the
// bf16 cache (K8's k_new / v_new, copied into the ring with the chunk),
// shared memory on the int8 one (K11's quantized row and, at fresh_scales,
// its k and v scales, written into the ring once the chunk has landed, as
// they are ready only after `pre`).
struct Rows {
  const unsigned char* k;
  const unsigned char* v;
  const float* ks;
  const float* vs;
  int fresh;
  const unsigned char* fresh_k;
  const unsigned char* fresh_v;
  const float* fresh_scales;
};

// The G query rows q [G][HD] (bf16, global memory; G <= kMaxG) against
// rows [s_beg, s_end) of `r`, by the block's kThreads threads; pre() runs, by
// every thread, once the ring's first chunks are on their way (K11 quantizes
// its new row there). Leaves in sm + BLOCK_OFF the block's acc [G][HD],
// m [G] and l [G] (unnormalized, m in the log2 domain; m = -inf, l = 0 and
// acc = 0 for a head that kept no row), and ends with a barrier.
// qk_scale = log2(e) / sqrt(hd).
template <int HD, bool BF, class Pre>
__device__ void attend(unsigned char* sm, const __nv_bfloat16* __restrict__ q, int G,
                       const Rows& r, int s_beg, int s_end, float qk_scale, Pre pre) {
  using Lay = Layout<HD, BF>;
  constexpr int KST = (HD + 15) / 16;  // k-steps of q . k (the last one half empty at hd % 16 == 8)
  constexpr int NO = HD / 8;           // 8-column tiles of the output
  constexpr int VB = HD / 8;           // bytes of a value row a lane reads (int8)
  constexpr int CS = Lay::CS;
  constexpr int NOW = Lay::NOW;        // the output n-tiles of one warp
  constexpr int PIECES = Lay::ROW / Lay::PIECE;
  constexpr int TAIL = HD % 64 / 4;    // int8: bytes of the row's tail a lane holds
  // the alignment of a lane's value run (int8): VB g + cs NOW bytes into a row
  constexpr int RA = align_of(VB) < align_of(CS > 1 ? NOW : 4) ? align_of(VB)
                                                              : align_of(CS > 1 ? NOW : 4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane
  const int MT = G > 16 ? 2 : 1;            // m-tiles of 16 query rows
  const int units = MT * CS;                // (m-tile, column slice) pairs
  const int mt = warp % MT, cs = CS > 1 ? (warp / MT) % CS : 0;
  const int kq = warp / units, KW = kWarps / units;
  const int nchunks = s_end > s_beg ? (s_end - s_beg + kRows - 1) / kRows : 0;

  auto issue = [&](int c) {
    unsigned char* st = sm + (c % kStages) * Lay::STAGE;
    const int s0 = s_beg + c * kRows;
    for (int i = tid; i < kRows * PIECES; i += kThreads) {
      const int row = i / PIECES, piece = i - row * PIECES;
      const int s = s0 + row;
      unsigned char* dk = st + row * Lay::KLD + Lay::PIECE * piece;
      unsigned char* dv = st + Lay::V_OFF + row * Lay::VLD + Lay::PIECE * piece;
      if (s == r.fresh && !BF) {  // K11's new row: written once the chunk has landed
      } else if (s == r.fresh) {  // K8's new row, from k_new / v_new
        cp_async16(dk, r.fresh_k + 16 * piece, true);
        cp_async16(dv, r.fresh_v + 16 * piece, true);
      } else {
        const bool ok = s < s_end;
        const size_t off = (size_t)(ok ? s : s_beg) * Lay::ROW + Lay::PIECE * piece;
        cp_async_piece<Lay::PIECE>(dk, r.k + off, ok);
        cp_async_piece<Lay::PIECE>(dv, r.v + off, ok);
      }
    }
    if (!BF) {
      // the scales of row 16 b + j at 16 b + 4 (j % 4) + j / 4: quad lane t
      // then reads the four of its columns (rows t, t + 4, t + 8, t + 12) at once
      for (int i = tid; i < 2 * kRows; i += kThreads) {
        const int which = i / kRows, row = i - which * kRows;
        const int s = s0 + row;
        float* dst = reinterpret_cast<float*>(st + (which ? Lay::VS_OFF : Lay::KS_OFF)) +
                     (row & ~15) + 4 * (row & 3) + ((row & 15) >> 2);
        if (s != r.fresh) {
          const bool ok = s < s_end;
          cp_async4(dst, (which ? r.vs : r.ks) + (ok ? s : s_beg), ok);
        }
      }
    }
    cp_async_commit();
  };

  // A fragments of q for this warp's m-tile, rows past G zero, and the
  // columns past hd (the last k-step's upper half at hd % 16 == 8)
  uint32_t qf[KST][4];
#pragma unroll
  for (int kk = 0; kk < KST; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = BF ? 16 * kk + 2 * t + 8 * half : kdim<HD>(kk, t) + 2 * half;
      const bool in = BF ? 16 * kk + 8 * half < HD : kpair_in<HD>(kk, half);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 16 * mt + g + 8 * rr;
        qf[kk][rr + 2 * half] =
            in && row < G ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * HD + d) : 0u;
      }
    }
  }

  float o[NOW][4];
#pragma unroll
  for (int n = 0; n < NOW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  // the ring's first kStages chunks, then chunk c + kStages - 1 into the
  // stage chunk c - 1 left, once every warp is done with it
#pragma unroll
  for (int c = 0; c < kStages; ++c) {
    if (c < nchunks) issue(c);
    else cp_async_commit();
  }
  pre();
  for (int c = 0; c < nchunks; ++c) {
    // chunk c is commit group c: the groups after it are chunks c + 1 and
    // c + 2 at c = 0, chunk c + 1 (or an empty group) later
    if (c == 0) cp_async_wait<kStages - 1>();
    else cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c - 1's stage is free
    if (c > 0) {
      if (c + kStages - 1 < nchunks) issue(c + kStages - 1);
      else cp_async_commit();
    }
    unsigned char* st = sm + (c % kStages) * Lay::STAGE;
    const int s0 = s_beg + c * kRows;
    if (!BF && r.fresh >= s0 && r.fresh < s0 + kRows) {  // K11's new row into its chunk
      const int row = r.fresh - s0;
      if (tid < 2 * PIECES) {
        const int which = tid / PIECES, piece = tid - which * PIECES;
        unsigned char* dst = st + (which ? Lay::V_OFF + row * Lay::VLD : row * Lay::KLD) +
                             Lay::PIECE * piece;
        const unsigned char* src = (which ? r.fresh_v : r.fresh_k) + Lay::PIECE * piece;
        if constexpr (Lay::PIECE == 16)
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        else
          *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
      } else if (tid < 2 * PIECES + 2) {
        const int which = tid - 2 * PIECES;
        reinterpret_cast<float*>(st + (which ? Lay::VS_OFF : Lay::KS_OFF))
            [(row & ~15) + 4 * (row & 3) + ((row & 15) >> 2)] = r.fresh_scales[which];
      }
      __syncthreads();
    }
    for (int kb = kq; kb < kRows / 16 && s0 + 16 * kb < s_end; kb += KW) {
      const unsigned char* kt = st + 16 * kb * Lay::KLD;
      const unsigned char* vt = st + Lay::V_OFF + 16 * kb * Lay::VLD;
      // scores of the block's 16 keys: two n-tiles of 8, each summed in two
      // halves (even and odd k-steps) to halve the chain of dependent mmas
      float s[2][4], s2[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][e] = s2[h][e] = 0.f;
      if constexpr (BF) {
#pragma unroll
        for (int kk = 0; kk < KST; ++kk) {
          uint32_t bf[4];
          ldsm_x4(bf, kt + ((lm >> 1) * 8 + lr) * Lay::KLD + 32 * kk + 16 * (lm & 1));
          if (HD % 16 != 0 && kk == KST - 1) bf[1] = bf[3] = 0u;  // columns past hd: the pad
          mma_bf16(kk & 1 ? s2[0] : s[0], qf[kk], bf);
          mma_bf16(kk & 1 ? s2[1] : s[1], qf[kk], bf + 2);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* kr = kt + (8 * h + (g >> 1) + 4 * (g & 1)) * Lay::KLD;
          uint32_t kw[KST];
#pragma unroll
          for (int b = 0; b < HD / 64; ++b) load_words<16>(kw + 4 * b, kr + 64 * b + 16 * t);
          if constexpr (TAIL != 0)
            load_run<TAIL, align_of(TAIL)>(kw + 4 * (HD / 64), kr + 64 * (HD / 64) + TAIL * t);
#pragma unroll
          for (int kk = 0; kk < KST; ++kk) {
            const uint32_t ux = kw[kk] ^ 0x80808080u;
            const uint32_t b[2] = {top_halves(code<0>(ux), code<1>(ux)),
                                   top_halves(code<2>(ux), code<3>(ux))};
            mma_bf16(kk & 1 ? s2[h] : s[h], qf[kk], b);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][e] += s2[h][e];
      // column scales and the mask: element e of n-tile h is key
      // s0 + 16 kb + key_of(h, e & 1)
      float colscale[2][2], vsc[2][2];
      int key_of[2][2];
      if constexpr (BF) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            colscale[h][j] = qk_scale;
            vsc[h][j] = 1.f;
            key_of[h][j] = 8 * h + 2 * t + j;
          }
      } else {
        const float4 k4 = *reinterpret_cast<const float4*>(st + Lay::KS_OFF + 4 * (16 * kb + 4 * t));
        const float4 v4 = *reinterpret_cast<const float4*>(st + Lay::VS_OFF + 4 * (16 * kb + 4 * t));
        colscale[0][0] = k4.x * qk_scale; colscale[0][1] = k4.y * qk_scale;
        colscale[1][0] = k4.z * qk_scale; colscale[1][1] = k4.w * qk_scale;
        vsc[0][0] = v4.x; vsc[0][1] = v4.y; vsc[1][0] = v4.z; vsc[1][1] = v4.w;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) key_of[h][j] = 8 * h + t + 4 * j;
      }
      const int lim = s_end - s0 - 16 * kb;  // keys at or past it are masked
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = key_of[h][e & 1] < lim ? s[h][e] * colscale[h][e & 1] : -INFINITY;
          s[h][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float base[2], alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float mnew = fmaxf(m[rr], mx[rr]);
        base[rr] = mnew == -INFINITY ? 0.f : mnew;  // a row with no key yet stays at 0
        alpha[rr] = exp2f(m[rr] - base[rr]);
        m[rr] = mnew;
        l[rr] *= alpha[rr];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[h][e] - base[e >> 1]);
          l[e >> 1] += p;
          s[h][e] = p * vsc[h][e & 1];
        }
#pragma unroll
      for (int n = 0; n < NOW; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      if constexpr (BF) {
        // n-tiles n0 + n of the output, in pairs (the pair past an odd NO
        // reads the row's 16-byte pad and is dropped)
        const int n0 = cs * NOW;
#pragma unroll
        for (int n = 0; n < NOW; n += 2) {
          if (CS > 1 && n0 + n >= NO) break;
          uint32_t bf[4];
          ldsm_x4_trans(bf, vt + ((lm & 1) * 8 + lr) * Lay::VLD + 16 * (n0 + n + (lm >> 1)));
          mma_bf16(o[n], pa, bf);
          if (n + 1 < NOW && (CS == 1 || n0 + n + 1 < NO)) mma_bf16(o[n + 1], pa, bf + 2);
        }
      } else {
        // rows t + 4 i, bytes [VB g + cs NOW, + NOW): output column VB g + cs NOW + n
        // of n-tile cs NOW + n
        constexpr int RW = (NOW + 3) / 4;
        uint32_t vw[4][RW];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          load_run<NOW, RA>(vw[i], vt + (t + 4 * i) * Lay::VLD + VB * g + cs * NOW);
#pragma unroll
          for (int w = 0; w < RW; ++w) vw[i][w] ^= 0x80808080u;
        }
#pragma unroll
        for (int n = 0; n < NOW; ++n) {
          if (CS > 1 && cs * NOW + n >= NO) break;
          float f[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t ux = vw[i][n / 4];
            f[i] = (n & 3) == 0 ? code<0>(ux) : (n & 3) == 1 ? code<1>(ux)
                 : (n & 3) == 2 ? code<2>(ux) : code<3>(ux);
          }
          const uint32_t b[2] = {top_halves(f[0], f[1]), top_halves(f[2], f[3])};
          mma_bf16(o[n], pa, b);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: its memory now holds the merge

  // each warp's rows: output [16][OLD] in fragment order (its n-tile n,
  // column c at 8 n + c), m, l
  float* wo = reinterpret_cast<float*>(sm + warp * Lay::WARP_PART);
  float* wm = wo + 16 * Lay::OLD;
  float* wl = wm + 16;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int row = g + 8 * rr;
#pragma unroll
    for (int n = 0; n < NOW; ++n)
      *reinterpret_cast<float2*>(wo + row * Lay::OLD + 8 * n + 2 * t) =
          make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
    if (t == 0) {
      wm[row] = m[rr];
      wl[row] = l[rr];
    }
  }
  __syncthreads();
  // the block's heads: the warps of a head's m-tile merged; first each
  // head's max, sum (from the warps of column slice 0: a slice's warps share
  // the scores) and the warps' weights, then the outputs, each column from
  // the warps of its slice
  float* bacc = reinterpret_cast<float*>(sm + Lay::BLOCK_OFF);
  float* bm = bacc + kMaxG * HD;
  float* bl = bm + kMaxG;
  float* wgt = reinterpret_cast<float*>(sm + Lay::WEIGHT_OFF);  // [kMaxG][kWarps]
  if (tid < G) {
    const int head = tid, row = head & 15;
    float mmax = -INFINITY;
    for (int w = head >> 4; w < kWarps; w += MT) {
      const float* p = reinterpret_cast<const float*>(sm + w * Lay::WARP_PART);
      mmax = fmaxf(mmax, p[16 * Lay::OLD + row]);
    }
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* p = reinterpret_cast<const float*>(sm + w * Lay::WARP_PART);
      const float mw = p[16 * Lay::OLD + row];
      const bool mine = w % MT == head >> 4 && mw != -INFINITY;
      const float f = mine ? exp2f(mw - mmax) : 0.f;
      wgt[head * kWarps + w] = f;
      if (CS == 1 || (w / MT) % CS == 0) lsum = fmaf(p[16 * Lay::OLD + 16 + row], f, lsum);
    }
    bm[head] = mmax;
    bl[head] = lsum;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int head = i / HD, d = i - head * HD;
    const int n = BF ? d >> 3 : d % VB;   // n-tile and column of dim d
    const int col = BF ? d & 7 : d / VB;
    const int c = CS > 1 ? n / NOW : 0;   // its column slice
    const int at = (head & 15) * Lay::OLD + 8 * (n - c * NOW) + col;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = wgt[head * kWarps + w];
      if (f != 0.f && (CS == 1 || (w / MT) % CS == c))
        acc = fmaf(reinterpret_cast<const float*>(sm + w * Lay::WARP_PART)[at], f, acc);
    }
    bacc[head * HD + d] = acc;
  }
  __syncthreads();
}

}  // namespace
}  // namespace kvd
