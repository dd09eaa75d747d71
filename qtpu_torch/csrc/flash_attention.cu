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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  constexpr int KST = HD / 16;    // k-steps of Q K^T
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
      qf[kk][r + 2] = row < a.S ? ld_pair(src + 8) : 0u;
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
        mma_bf16(o[n + 1], pa, bf + 2);
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

}  // namespace

// o = attention(q, k, v) with the strides given in elements (the head dim
// is contiguous in all four). q/o need even strides and 4-byte alignment;
// k/v strides that are multiples of 8 and 16-byte alignment (16-byte row
// loads). Returns a cudaError_t (0 on success), or -1 for arguments the
// kernel does not take.
extern "C" int qtpu_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KV, int S, int hd, int window, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || S <= 0 || H % KV != 0 || (hd != 64 && hd != 128) ||
      B > 65535 || H > 65535)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  if (hd == 64) {
    flash_attn_kernel<64><<<grid, kThreads, smem_bytes<64>(), st>>>(a);
  } else {
    // above the 48 KB a block gets without asking
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_attn_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<128>());
    if (attr != cudaSuccess) return (int)attr;
    flash_attn_kernel<128><<<grid, kThreads, smem_bytes<128>(), st>>>(a);
  }
  return (int)cudaGetLastError();
}
