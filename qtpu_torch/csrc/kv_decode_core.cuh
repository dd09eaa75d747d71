// The decode-attention core shared by K3's kernel (csrc/kv_attention.cu:
// K3, K8, K11 and the one-layer entry) and K12's split body
// (csrc/kv_flash_decode.cu): one block attends the G query heads of one
// (sequence, kv-head) over one slice [s_beg, s_end) of its cache rows and
// leaves its unnormalized (m, l, acc) in shared memory.
//
// Bound: the bytes of the slice (int8 k and v codes and their two f32
// scales a row, or bf16 k and v). What the design does about it:
//  * an asynchronous ring of raw chunks: kRows rows of k and v at one byte a
//    code (two a value on the bf16 cache) plus the scales, filled by 16-byte
//    cp.async.cg copies (the scales by 4-byte cp.async.ca, as a slice may
//    start at any row), kStages stages: the first three chunks are issued
//    at once, then two are in flight while a third is computed. Rows past
//    the slice are zero-filled, never read;
//  * q . k and p . v on the tensor cores: mma.sync m16n8k16 bf16 -> f32.
//    A of q . k is the G query rows (rows G..15 zero; G > 16 takes two
//    m-tiles), loaded once into registers; B is the key codes converted
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
// Head dims: any multiple of 16 from 32 to 128. A row's bytes are 64-byte
// blocks (4 k-steps, 16 bytes a lane) and a tail of hd % 64 bytes (0, 1, 2
// or 3 k-steps, 4, 8 or 12 bytes a lane). A lane's run of hd / 8 value bytes
// starts 4-byte aligned when hd % 32 == 0; at hd 48, 80 and 112 it may start
// 2 bytes in, and is read as whole words from the word below, shifted
// (load_run).
//
// Shared memory a block (Layout::SMEM): hd 64: 3 x 11.5 KB = 34.5 KB; hd
// 80: 3 x 13.5 KB = 40.5 KB; hd 128: 3 x 19.5 KB = 58.5 KB; bf16 cache hd
// 64: 54 KB (K8).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvd {
namespace {

constexpr int kRows = 64;    // cache rows a chunk
constexpr int kStages = 3;   // ring stages
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 32;    // query heads a kv-head
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, bool BF>
struct Layout {
  static constexpr int ROW = BF ? 2 * HD : HD;  // bytes of a cache row
  // k row pitch in the ring
  static constexpr int KLD = BF || HD % 32 == 0 ? ROW + 16 : ROW + 32;
  static constexpr int VLD = BF ? ROW + 16 : (HD == 32 || HD == 96 ? HD : HD + 32);
  static constexpr int V_OFF = kRows * KLD;
  static constexpr int KS_OFF = V_OFF + kRows * VLD;   // int8: k scales of the chunk
  static constexpr int VS_OFF = KS_OFF + (BF ? 0 : 4 * kRows);
  static constexpr int STAGE = VS_OFF + (BF ? 0 : 4 * kRows);
  static constexpr int RING = kStages * STAGE;
  // once the ring is drained: each warp's output [16][HD + 8] in fragment
  // order (rows padded so that its float2 stores spread over the banks),
  // m[16], l[16]; then the block's acc [kMaxG][HD], m[kMaxG], l[kMaxG]; then
  // each warp's weight in each head's merge [kMaxG][kWarps]
  static constexpr int OLD = HD + 8;
  static constexpr int WARP_PART = 4 * (16 * OLD + 32);
  static constexpr int BLOCK_OFF = kWarps * WARP_PART;
  static constexpr int BLOCK_PART = 4 * (kMaxG * HD + 2 * kMaxG);
  static constexpr int WEIGHT_OFF = BLOCK_OFF + BLOCK_PART;
  static constexpr int MERGE = WEIGHT_OFF + 4 * kMaxG * kWarps;
  static constexpr int USED = RING > MERGE ? RING : MERGE;
  static constexpr int SMEM = USED + 16;  // + 16: the base is aligned by hand
};

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
// trailing block of hd % 64 bytes (16, 32 or 48) a quarter of it (1, 2 or 3
// k-steps).
template <int HD>
__device__ __forceinline__ int kdim(int kk, int t) {
  constexpr int FULL = 4 * (HD / 64);  // k-steps in full 64-byte blocks
  return kk < FULL ? 64 * (kk / 4) + 16 * t + 4 * (kk % 4)
                   : 64 * (HD / 64) + (HD % 64 / 4) * t + 4 * (kk - FULL);
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

// A lane's run of VB value bytes at p (2-byte aligned) into (VB + 3) / 4
// words, byte i of the run at byte i % 4 of word i / 4: load_words where p is
// 4-byte aligned (VB % 4 == 0); else the words from the one below p, shifted
// down by 16 bits where p is 2 bytes past it (VB = 6, 10, 14: the run and its
// 2-byte offset fit those words).
template <int VB>
__device__ __forceinline__ void load_run(uint32_t* w, const unsigned char* p) {
  if constexpr (VB % 4 == 0) {
    load_words<VB>(w, p);
  } else {
    constexpr int RW = (VB + 3) / 4;
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
    const uint32_t sh = (a & 2) ? 16u : 0u;
    uint32_t x[RW + 1];
#pragma unroll
    for (int i = 0; i < RW; ++i) x[i] = src[i];
    x[RW] = 0u;
#pragma unroll
    for (int i = 0; i < RW; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], sh);
  }
}

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

// The G query rows q [G][HD] (bf16, global memory) against rows
// [s_beg, s_end) of `r`, by the block's kThreads threads; pre() runs, by
// every thread, once the ring's first chunks are on their way (K11 quantizes
// its new row there). Leaves in sm + BLOCK_OFF the block's acc [G][HD],
// m [G] and l [G] (unnormalized, m in the log2 domain; m = -inf, l = 0 and
// acc = 0 for a head that kept no row), and ends with a barrier.
// qk_scale = log2(e) / sqrt(hd).
template <int HD, bool BF, class Pre>
__device__ void attend(unsigned char* sm, const __nv_bfloat16* __restrict__ q, int G,
                       const Rows& r, int s_beg, int s_end, float qk_scale, Pre pre) {
  using Lay = Layout<HD, BF>;
  constexpr int KST = HD / 16;  // k-steps of q . k
  constexpr int NO = HD / 8;    // 8-column tiles of the output
  constexpr int VB = HD / 8;    // bytes of a value row a lane reads (int8)
  constexpr int PIECES = Lay::ROW / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row and matrix of this lane
  const int MT = G > 16 ? 2 : 1;            // m-tiles of 16 query rows
  const int mt = warp % MT, kq = warp / MT, KW = kWarps / MT;
  const int nchunks = s_end > s_beg ? (s_end - s_beg + kRows - 1) / kRows : 0;

  auto issue = [&](int c) {
    unsigned char* st = sm + (c % kStages) * Lay::STAGE;
    const int s0 = s_beg + c * kRows;
    for (int i = tid; i < kRows * PIECES; i += kThreads) {
      const int row = i / PIECES, piece = i - row * PIECES;
      const int s = s0 + row;
      unsigned char* dk = st + row * Lay::KLD + 16 * piece;
      unsigned char* dv = st + Lay::V_OFF + row * Lay::VLD + 16 * piece;
      if (s == r.fresh && !BF) {  // K11's new row: written once the chunk has landed
      } else if (s == r.fresh) {  // K8's new row, from k_new / v_new
        cp_async16(dk, r.fresh_k + 16 * piece, true);
        cp_async16(dv, r.fresh_v + 16 * piece, true);
      } else {
        const bool ok = s < s_end;
        const size_t off = (size_t)(ok ? s : s_beg) * Lay::ROW + 16 * piece;
        cp_async16(dk, r.k + off, ok);
        cp_async16(dv, r.v + off, ok);
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

  // A fragments of q for this warp's m-tile, rows G..15 (or 16 + G..31) zero
  uint32_t qf[KST][4];
#pragma unroll
  for (int kk = 0; kk < KST; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = BF ? 16 * kk + 2 * t + 8 * half : kdim<HD>(kk, t) + 2 * half;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 16 * mt + g + 8 * rr;
        qf[kk][rr + 2 * half] =
            row < G ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * HD + d) : 0u;
      }
    }
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
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
        *reinterpret_cast<int4*>(st + (which ? Lay::V_OFF + row * Lay::VLD : row * Lay::KLD) +
                                 16 * piece) =
            *reinterpret_cast<const int4*>((which ? r.fresh_v : r.fresh_k) + 16 * piece);
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
          if constexpr (HD % 64 != 0)
            load_words<HD % 64 / 4>(kw + 4 * (HD / 64), kr + 64 * (HD / 64) + (HD % 64 / 4) * t);
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
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      if constexpr (BF) {
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vt + ((lm & 1) * 8 + lr) * Lay::VLD + 16 * (n + (lm >> 1)));
          mma_bf16(o[n], pa, bf);
          mma_bf16(o[n + 1], pa, bf + 2);
        }
      } else {
        // rows t + 4 i, bytes [VB g, VB g + VB): output column VB g + n of n-tile n
        uint32_t vw[4][(VB + 3) / 4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          load_run<VB>(vw[i], vt + (t + 4 * i) * Lay::VLD + VB * g);
#pragma unroll
          for (int w = 0; w < (VB + 3) / 4; ++w) vw[i][w] ^= 0x80808080u;
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
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

  // each warp's rows: output [16][OLD] in fragment order (n-tile n, column
  // c at 8 n + c), m, l
  float* wo = reinterpret_cast<float*>(sm + warp * Lay::WARP_PART);
  float* wm = wo + 16 * Lay::OLD;
  float* wl = wm + 16;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int row = g + 8 * rr;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(wo + row * Lay::OLD + 8 * n + 2 * t) =
          make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
    if (t == 0) {
      wm[row] = m[rr];
      wl[row] = l[rr];
    }
  }
  __syncthreads();
  // the block's heads: the warps of a head's m-tile merged; first each
  // head's max, sum and the warps' weights, then the outputs
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
      lsum = fmaf(p[16 * Lay::OLD + 16 + row], f, lsum);
    }
    bm[head] = mmax;
    bl[head] = lsum;
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int head = i / HD, d = i - head * HD;
    const int at = (head & 15) * Lay::OLD + (BF ? d : 8 * (d % VB) + d / VB);
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = wgt[head * kWarps + w];
      if (f != 0.f) acc = fmaf(reinterpret_cast<const float*>(sm + w * Lay::WARP_PART)[at], f, acc);
    }
    bacc[head * HD + d] = acc;
  }
  __syncthreads();
}

}  // namespace
}  // namespace kvd
