// K2, K3, K8 and K11: the KV cache of the decode step.
//
// K2 (qtpu_kv_band_write) replaces pallas_cache_band_write_stacked
// (qtpu/kernels/pallas_kv_attention.py:1067): quantize this step's k and v
// rows per (sequence, kv-head) to symmetric int8 with an f32 scale
// absmax/127 and write them in place at `pos` into one layer of the stacked
// [L, B, KV, S, hd] cache. Rows with pos outside [0, S) write nothing.
// Bound: a few bytes per (b, head); launch latency dominates, so a faster
// body cannot help. Design: one warp per (b, head), launched with
// programmatic dependent launch (band_write_pdl_kernel: its launch and the
// index math and pos read overlap the tail of the kernel before it, which
// must not write pos; griddepcontrol.wait comes before the k/v rows are
// read); each lane reads 16 bytes (8 values) of the k or the v row, the
// warp reduces both rows' absmax with shuffles, and the lane writes its 8
// codes with two 4-byte stores, lane 0 the two scales; nothing else of the
// cache is touched (the TPU kernel moved an 8-row band because its DMA unit
// is a tile). The earlier kernel (band_write_kernel: a plain launch, a
// warp's scalar pass over k, then v) stays behind qtpu_kv_band_write_simt
// for chip_smoke.py's "was" time.
//
// K3 (qtpu_decode_attention) replaces pallas_decode_attention_stacked
// (pallas_kv_attention.py:1147): GQA decode attention of one query row per
// head over layer l of the int8 cache, scales folded in as the TPU kernel
// does (scores = (q . k_int) * ks / sqrt(hd); out = sum (p * vs) v_int).
// Bound: the bytes of the cache rows up to pos (int8 k and v plus the f32
// scales). Design: K3's kernel, below. Rows with pos >= S (inactive batch
// slots) read rows [0, S) only.
//
// K8 (qtpu_decode_attention_write_bf16) replaces
// pallas_decode_attention_write_bf16 (pallas_kv_attention.py:262): on a bf16
// cache, write this step's k and v rows in place at pos and attend the G
// query heads over s <= pos (inside the window when one binds) in one
// launch per layer. Rows with pos >= S write nothing. Bound: the bytes of the
// cache rows up to pos (bf16 k and v) plus the written row. Design: K3's
// kernel without the scales, writing the new row and staging it from the
// new k/v, never reading it back from the cache. Scores and the softmax are
// f32; the probabilities are rounded to bf16 for the PV product (the TPU
// kernel's and the plain version's rounding point, here on the online
// softmax's unnormalized weights, as K5 does).
//
// K11 (qtpu_decode_attention_write) replaces pallas_decode_attention_write
// (pallas_kv_attention.py:313): on the int8 cache, quantize this step's k and
// v rows with K2's rounding, write the codes and scales in place at pos and
// attend over the updated layer in one launch per layer. Rows with pos
// outside [0, S) write nothing. Bound: the bytes of the cache rows up to pos
// (int8 k and v plus the f32 scales) and the written row. Design: K3's kernel
// with K8's write: two warps quantize the new rows into shared memory, the
// block writes them to the cache and stages the row at pos from shared
// memory, never reading it back.
//
// Design of K3's kernel (all four modes): the S rows a
// (sequence, kv-head) attends to are split over the blocks of a thread-block
// cluster (decode_attn_cluster_kernel), each block one contiguous slice of
// whole 64-row chunks (kvd_slice; the cluster size is the wrapper's rule,
// `decode_cluster` in kernels/kv_attention.py: as many blocks as leave each
// an SM of its own, at most 8, at most one per chunk of S: past that the
// cluster's fixed costs outgrow the rows a block saves). Each block runs the shared
// core (kv_decode_core.cuh: raw int8 or bf16 chunks through a cp.async ring,
// q . k and p . v on mma.sync over the codes converted to bf16 in registers,
// p * v_scale rounded to bf16 as the TPU kernel does), then the slices'
// (m, l, acc) are merged through distributed shared memory into the output
// in the same launch (no scratch, no second launch). The block whose slice
// holds pos is the one that writes the new row (K8, K11) and stages it from
// k_new / v_new (K8) or from its own shared memory (K11); no other block
// reads row pos. A kv-head with more than 32 q heads (kvd::kMaxG) is split
// over a second grid axis of head groups, each group's clusters reading the
// same rows (group 0 writes the new row). The earlier body, decode_attn_kernel (one block per
// (sequence, kv-head), f32 staging, scalar FMAs), stays behind the `_simt`
// entries for chip_smoke.py's "was" times; no model path reaches it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_decode_core.cuh"

namespace {

constexpr int kChunk = 128;  // cache rows per staged chunk (the earlier body)
// The earlier body's shared memory is 4 * (G*hd + kChunk*(2*hd + 1) + 2*kChunk +
// G*kChunk) bytes: 161 KB at hd = 128 and G = 32, within the card's 227 KB; hd
// = 256 would not fit, so it keeps hd % 16 == 0, hd <= 128, G <= 32.
constexpr int kMaxHd = 128;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ void quantize_row(const __nv_bfloat16* src, int8_t* dst, float* scale_out,
                             int hd, int lane) {
  float amax = 0.f;
  for (int i = lane; i < hd; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[i])));
  amax = warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  for (int i = lane; i < hd; i += 32) {
    float q = rintf(__bfloat162float(src[i]) / scale);  // round half to even
    q = fminf(fmaxf(q, -127.f), 127.f);
    dst[i] = (int8_t)q;
  }
  if (lane == 0) *scale_out = scale;
}

// grid B * KV, block 32
__global__ void band_write_kernel(const __nv_bfloat16* __restrict__ k_new,
                                  const __nv_bfloat16* __restrict__ v_new,
                                  int8_t* k_c, int8_t* v_c, float* ks_c, float* vs_c,
                                  const int* __restrict__ pos, int KV, int S, int hd) {
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  const size_t src = ((size_t)b * KV + h) * hd;
  const size_t row = ((size_t)b * KV + h) * S + p;
  quantize_row(k_new + src, k_c + row * hd, ks_c + row, hd, threadIdx.x);
  quantize_row(v_new + src, v_c + row * hd, vs_c + row, hd, threadIdx.x);
}

// The quantized code of value x at scale `scale` (quantize_row's rounding).
__device__ __forceinline__ uint32_t quantize_code(float x, float scale) {
  const float q = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);  // round half to even
  return (uint32_t)(uint8_t)(int8_t)q;
}

// grid B * KV, block 32; hd % 8 == 0, hd <= 256 (at most 2 16-byte chunks of
// [k row | v row] a lane), k_new / v_new 16-byte aligned, the cache layer's
// codes 4-byte aligned. Launched with or without the programmatic attribute
// (griddepcontrol.wait is then a no-op).
__global__ void __launch_bounds__(32) band_write_pdl_kernel(
    const __nv_bfloat16* __restrict__ k_new, const __nv_bfloat16* __restrict__ v_new,
    int8_t* k_c, int8_t* v_c, float* ks_c, float* vs_c, const int* __restrict__ pos, int KV,
    int S, int hd) {
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x - b * KV;
  const int lane = threadIdx.x;
  const int cpr = hd / 8;  // 16-byte chunks a row
  const size_t src = ((size_t)b * KV + h) * hd;
  const int p = pos[b];  // written before the kernel ahead of this one
  const size_t row = ((size_t)b * KV + h) * S + p;
  // this step's k / v rows come from the kernel before this one: wait for it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (p < 0 || p >= S) return;
  uint4 w[2];
  float mk = 0.f, mv = 0.f;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int c = lane + 32 * it;  // chunk c of [k row | v row]
    if (c < 2 * cpr) {
      const bool isv = c >= cpr;
      w[it] = *reinterpret_cast<const uint4*>((isv ? v_new : k_new) + src + 8 * (isv ? c - cpr : c));
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w[it]);
      float m = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
      if (isv) mv = fmaxf(mv, m);
      else mk = fmaxf(mk, m);
    }
  }
  const float sk = fmaxf(warp_max(mk) / 127.0f, 1e-8f);
  const float sv = fmaxf(warp_max(mv) / 127.0f, 1e-8f);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int c = lane + 32 * it;
    if (c < 2 * cpr) {
      const bool isv = c >= cpr;
      const float scale = isv ? sv : sk;
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w[it]);
      uint32_t word[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 f0 = __bfloat1622float2(h2[2 * j]);
        const float2 f1 = __bfloat1622float2(h2[2 * j + 1]);
        word[j] = quantize_code(f0.x, scale) | quantize_code(f0.y, scale) << 8 |
                  quantize_code(f1.x, scale) << 16 | quantize_code(f1.y, scale) << 24;
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>((isv ? v_c : k_c) + row * hd +
                                                  8 * (isv ? c - cpr : c));
      dst[0] = word[0];
      dst[1] = word[1];
    }
  }
  if (lane == 0) {
    ks_c[row] = sk;
    vs_c[row] = sv;
  }
}

// grid B * KV, block G * 32. BF = false, QW = false: K3 on the int8 cache
// with its scales (k_new, v_new unused). BF = true: K8 on the bf16 cache,
// which it writes at pos (ks_c, vs_c unused). QW = true: K11 on the int8
// cache, which it quantizes the new rows into and writes at pos.
template <bool BF, bool QW>
__global__ void decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                                   const void* k_cache, const void* v_cache,
                                   const float* ks_c, const float* vs_c,
                                   const __nv_bfloat16* __restrict__ k_new,
                                   const __nv_bfloat16* __restrict__ v_new,
                                   const int* __restrict__ pos,
                                   __nv_bfloat16* __restrict__ out, int KV, int G, int S,
                                   int hd, int window, float sm_scale) {
  extern __shared__ float sm[];
  const int HD1 = hd + 1;  // padded K rows: lanes reading one column hit distinct banks
  float* qs = sm;                         // [G][hd]
  float* Ks = qs + G * hd;                // [kChunk][hd + 1]
  float* Vs = Ks + kChunk * HD1;          // [kChunk][hd]
  float* kss = Vs + kChunk * hd;          // [kChunk]
  float* vss = kss + kChunk;              // [kChunk]
  float* pv = vss + kChunk;               // [G][kChunk]

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int g = tid / 32;
  const int lane = tid % 32;
  const int H = KV * G;
  const size_t qoff = ((size_t)b * H + (size_t)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += nthr) qs[i] = __bfloat162float(q[qoff + i]);

  const int p = pos[b];
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const size_t row0 = ((size_t)b * KV + kvh) * S;  // first row of this (b, head)
  const size_t nrow = ((size_t)b * KV + kvh) * hd;  // this head's new k/v row
  if (BF && p >= 0 && p < S) {
    __nv_bfloat16* kw = static_cast<__nv_bfloat16*>(const_cast<void*>(k_cache));
    __nv_bfloat16* vw = static_cast<__nv_bfloat16*>(const_cast<void*>(v_cache));
    for (int d = tid; d < hd; d += nthr) {
      kw[(row0 + p) * hd + d] = k_new[nrow + d];
      vw[(row0 + p) * hd + d] = v_new[nrow + d];
    }
  }
  // K11: the new rows' codes and scales, quantized by warps 0 and 1 (warp 0
  // alone when G = 1), then written at pos
  __shared__ __align__(16) int8_t newq[2][kMaxHd];
  __shared__ float newsc[2];
  if (QW) {
    for (int r = g; r < 2; r += G)
      quantize_row((r == 0 ? k_new : v_new) + nrow, newq[r], &newsc[r], hd, lane);
    __syncthreads();
    if (p >= 0 && p < S) {
      int8_t* kw = static_cast<int8_t*>(const_cast<void*>(k_cache));
      int8_t* vw = static_cast<int8_t*>(const_cast<void*>(v_cache));
      for (int d = tid; d < hd; d += nthr) {
        kw[(row0 + p) * hd + d] = newq[0][d];
        vw[(row0 + p) * hd + d] = newq[1][d];
      }
      if (tid == 0) {
        const_cast<float*>(ks_c)[row0 + p] = newsc[0];
        const_cast<float*>(vs_c)[row0 + p] = newsc[1];
      }
    }
  }

  constexpr int kPer = kMaxHd / 32;
  float o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int s0 = lo; s0 <= hi; s0 += kChunk) {
    const int n = min(kChunk, hi - s0 + 1);
    __syncthreads();  // the previous chunk (and qs on the first pass) is settled
    if (BF) {
      // 16-byte loads of 8 values; the row at pos comes from the new k/v
      const __nv_bfloat16* kc = static_cast<const __nv_bfloat16*>(k_cache) + (row0 + s0) * hd;
      const __nv_bfloat16* vc = static_cast<const __nv_bfloat16*>(v_cache) + (row0 + s0) * hd;
      for (int i = tid; i < n * hd / 8; i += nthr) {
        const int s = (8 * i) / hd;
        const int d = 8 * i - s * hd;
        const bool fresh = s0 + s == p;
        const int4 kw = *reinterpret_cast<const int4*>(fresh ? k_new + nrow + d : kc + 8 * i);
        const int4 vw = *reinterpret_cast<const int4*>(fresh ? v_new + nrow + d : vc + 8 * i);
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&kw);
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&vw);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          Ks[s * HD1 + d + t] = __bfloat162float(kb[t]);
          Vs[s * hd + d + t] = __bfloat162float(vb[t]);
        }
      }
    } else {
      // 16-byte loads: the chunk's rows are contiguous, hd % 16 == 0
      const int4* ksrc = reinterpret_cast<const int4*>(static_cast<const int8_t*>(k_cache) +
                                                       (row0 + s0) * hd);
      const int4* vsrc = reinterpret_cast<const int4*>(static_cast<const int8_t*>(v_cache) +
                                                       (row0 + s0) * hd);
      // (K11: the row at pos comes from the new codes in shared memory)
      for (int i = tid; i < n * hd / 16; i += nthr) {
        const int s = (16 * i) / hd;
        const int d = 16 * i - s * hd;
        const bool fresh = QW && s0 + s == p;
        const int4 kw = fresh ? *reinterpret_cast<const int4*>(&newq[0][d]) : __ldg(ksrc + i);
        const int4 vw = fresh ? *reinterpret_cast<const int4*>(&newq[1][d]) : __ldg(vsrc + i);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
        const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          Ks[s * HD1 + d + t] = (float)kb[t];
          Vs[s * hd + d + t] = (float)vb[t];
        }
      }
      for (int i = tid; i < n; i += nthr) {
        const bool fresh = QW && s0 + i == p;
        kss[i] = fresh ? newsc[0] : ks_c[row0 + s0 + i];
        vss[i] = fresh ? newsc[1] : vs_c[row0 + s0 + i];
      }
    }
    __syncthreads();
    float sc[kChunk / 32];
    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kChunk / 32; ++jj) {
      const int s = lane + 32 * jj;
      float v = -INFINITY;
      if (s < n) {
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qs[g * hd + d], Ks[s * HD1 + d], dot);
        v = BF ? dot * sm_scale : dot * kss[s] * sm_scale;
      }
      sc[jj] = v;
      cmax = fmaxf(cmax, v);
    }
    cmax = warp_max(cmax);
    const float mnew = fmaxf(m, cmax);
    const float alpha = expf(m - mnew);  // 0 on the first chunk
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kChunk / 32; ++jj) {
      const int s = lane + 32 * jj;
      if (s < n) {
        const float e = expf(sc[jj] - mnew);
        psum += e;
        pv[g * kChunk + s] = BF ? __bfloat162float(__float2bfloat16(e)) : e * vss[s];
      }
    }
    psum = warp_sum(psum);
    l = l * alpha + psum;
    m = mnew;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] *= alpha;
    for (int s = 0; s < n; ++s) {
      const float w = pv[g * kChunk + s];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) o[i] = fmaf(w, Vs[s * hd + d], o[i]);
      }
    }
  }
  const float inv = l > 0.f ? 1.0f / l : 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane + 32 * i;
    if (d < hd) out[qoff + (size_t)g * hd + d] = __float2bfloat16(o[i] * inv);
  }
}

template <bool BF, bool QW>
int launch_attn(const void* q, const void* k_c, const void* v_c, const float* ks_c,
                const float* vs_c, const __nv_bfloat16* k_new, const __nv_bfloat16* v_new,
                const void* pos, void* out, int B, int KV, int G, int S, int hd, int window,
                void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > 32 || S <= 0 || hd % 16 != 0 || hd > kMaxHd)
    return -1;
  static size_t smem_set = 48 * 1024;
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)kChunk * (2 * hd + 1) + 2 * kChunk +
                       (size_t)G * kChunk);
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<BF, QW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  decode_attn_kernel<BF, QW><<<B * KV, G * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_c, v_c, ks_c, vs_c, k_new, v_new,
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), KV, G, S, hd, window,
      1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// The slice [*beg, *end) of rank `rank` of a cluster of CL blocks over the
// rows a sequence at p attends to: s <= min(p, S - 1) (an inactive slot,
// p >= S, reads [0, S)), and s > p - window when window > 0. Slices are
// whole chunks but the last, in rank order; `decode_slices` in
// kernels/kv_attention.py is the same rule in Python.
__device__ __forceinline__ void kvd_slice(int p, int S, int window, int rank, int CL, int* beg,
                                          int* end) {
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int n = max(0, hi - lo + 1);
  const int per = ((n + CL - 1) / CL + kvd::kRows - 1) / kvd::kRows * kvd::kRows;
  *beg = lo + rank * per;
  *end = max(*beg, min(hi + 1, *beg + per));
}

// grid (CL * B * KV, head groups) in clusters of CL along x, block
// kvd::kThreads. Modes as decode_attn_kernel's. HD: a multiple of 8 from 8
// to 256 (the instances of cluster_part). A (sequence, kv-head)'s G
// heads are split over gridDim.y blocks of GB <= 32 heads (the last may hold
// fewer; kvd::head_groups): each group's clusters read the same rows, and
// only group 0's writer block writes the new row (every group's stages it).
template <int HD, bool BF, bool QW>
__global__ void __launch_bounds__(kvd::kThreads) decode_attn_cluster_kernel(
    const __nv_bfloat16* __restrict__ q, const void* k_cache, const void* v_cache,
    const float* ks_c, const float* vs_c, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, const int* __restrict__ pos,
    __nv_bfloat16* __restrict__ out, int KV, int G, int GB, int S, int window, float qk_scale,
    int CL) {
  extern __shared__ float sm[];
  unsigned char* base = kvd::align16(sm);
  __shared__ __align__(16) int8_t newq[2][HD];
  __shared__ float newsc[2];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.x / CL;
  const int b = head / KV, kvh = head - b * KV;
  const int h0 = blockIdx.y * GB;       // this block's first head of the kv-head
  const int Gb = min(GB, G - h0);       // and its heads
  const int tid = threadIdx.x;
  const int p = pos[b];
  int s_beg, s_end;
  kvd_slice(p, S, window, rank, CL, &s_beg, &s_end);
  const bool writer = (BF || QW) && p >= 0 && p < S && s_beg <= p && p < s_end;
  const bool writes = writer && blockIdx.y == 0;  // the one block that writes row pos
  const size_t row0 = ((size_t)b * KV + kvh) * S;  // first row of this (b, head)
  const size_t nrow = ((size_t)b * KV + kvh) * HD;  // this head's new k/v row
  const size_t qoff = ((size_t)b * KV * G + (size_t)kvh * G + h0) * HD;
  constexpr int ROW = kvd::Layout<HD, BF>::ROW;
  kvd::Rows r;
  r.k = static_cast<const unsigned char*>(k_cache) + row0 * ROW;
  r.v = static_cast<const unsigned char*>(v_cache) + row0 * ROW;
  r.ks = BF ? nullptr : ks_c + row0;
  r.vs = BF ? nullptr : vs_c + row0;
  r.fresh = writer ? p : -1;
  if (BF && writer) {
    if (writes) {
      __nv_bfloat16* kw = static_cast<__nv_bfloat16*>(const_cast<void*>(k_cache));
      __nv_bfloat16* vw = static_cast<__nv_bfloat16*>(const_cast<void*>(v_cache));
      for (int d = tid; d < HD; d += kvd::kThreads) {
        kw[(row0 + p) * HD + d] = k_new[nrow + d];
        vw[(row0 + p) * HD + d] = v_new[nrow + d];
      }
    }
    r.fresh_k = reinterpret_cast<const unsigned char*>(k_new + nrow);
    r.fresh_v = reinterpret_cast<const unsigned char*>(v_new + nrow);
  } else {
    r.fresh_k = reinterpret_cast<const unsigned char*>(newq[0]);
    r.fresh_v = reinterpret_cast<const unsigned char*>(newq[1]);
    r.fresh_scales = newsc;
  }
  // K11: the new rows' codes and scales, quantized by warps 0 and 1 while the
  // ring's first chunks load, then written at pos
  auto quantize = [&]() {
    if (!(QW && writer)) return;
    const int w = tid / 32;
    if (w < 2) quantize_row((w == 0 ? k_new : v_new) + nrow, newq[w], &newsc[w], HD, tid % 32);
    __syncthreads();
    if (!writes) return;
    int8_t* kw = static_cast<int8_t*>(const_cast<void*>(k_cache));
    int8_t* vw = static_cast<int8_t*>(const_cast<void*>(v_cache));
    for (int d = tid; d < HD; d += kvd::kThreads) {
      kw[(row0 + p) * HD + d] = newq[0][d];
      vw[(row0 + p) * HD + d] = newq[1][d];
    }
    if (tid == 0) {
      const_cast<float*>(ks_c)[row0 + p] = newsc[0];
      const_cast<float*>(vs_c)[row0 + p] = newsc[1];
    }
  };
  kvd::attend<HD, BF>(base, q + qoff, Gb, r, s_beg, s_end, qk_scale, quantize);
  float* bacc = reinterpret_cast<float*>(base + kvd::Layout<HD, BF>::BLOCK_OFF);
  constexpr int M_AT = kvd::kMaxG * HD, L_AT = M_AT + kvd::kMaxG;  // the block's m and l
  if (CL == 1) {  // one block: its own (m, l, acc) is the result
    for (int i = tid; i < Gb * HD; i += kvd::kThreads) {
      const float lsum = bacc[L_AT + i / HD];
      out[qoff + i] = __float2bfloat16(lsum > 0.f ? bacc[i] / lsum : 0.f);
    }
    return;
  }

  // the cluster's slices merged through distributed shared memory: rank
  // `rank` writes every CL-th run of kThreads output elements
  cluster.sync();  // every block's (m, l, acc) is in its shared memory
  for (int i = rank * kvd::kThreads + tid; i < Gb * HD; i += CL * kvd::kThreads) {
    const int h = i / HD, d = i - h * HD;
    float mmax = -INFINITY;
    for (int z = 0; z < CL; ++z) {
      const float* rb = cluster.map_shared_rank(bacc, z);
      mmax = fmaxf(mmax, rb[M_AT + h]);
    }
    float acc = 0.f, lsum = 0.f;
    if (mmax != -INFINITY) {
      for (int z = 0; z < CL; ++z) {
        const float* rb = cluster.map_shared_rank(bacc, z);
        const float mz = rb[M_AT + h];
        if (mz == -INFINITY) continue;  // an empty slice
        const float f = exp2f(mz - mmax);
        acc = fmaf(rb[h * HD + d], f, acc);
        lsum = fmaf(rb[L_AT + h], f, lsum);
      }
    }
    out[qoff + i] = __float2bfloat16(lsum > 0.f ? acc / lsum : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// One call of K3's kernel, in any of its modes.
struct KvCall {
  const void* q;
  const void* k_c;
  const void* v_c;
  const float* ks_c;
  const float* vs_c;
  const __nv_bfloat16* k_new;
  const __nv_bfloat16* v_new;
  const void* pos;
  void* out;
  int B, KV, G, S, window, cluster;
  cudaStream_t st;
};

template <int HD, bool BF, bool QW>
int launch_cluster(const KvCall& c) {
  auto kernel = decode_attn_cluster_kernel<HD, BF, QW>;
  const int groups = kvd::head_groups(c.G), GB = kvd::group_heads(c.G);
  if (groups > 65535) return -1;
  constexpr int smem = kvd::Layout<HD, BF>::SMEM;
  static bool smem_set = false;  // this instance's record, in this library
  if (!smem_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c.cluster * c.B * c.KV), (unsigned)groups);
  cfg.blockDim = dim3(kvd::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = c.st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static bool fits[9] = {};  // cluster sizes checked co-resident, this instance
  if (!fits[c.cluster]) {
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n == 0) return -2;  // no cluster of this size fits on the card
    fits[c.cluster] = true;
  }
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(c.q), c.k_c, c.v_c, c.ks_c, c.vs_c,
      c.k_new, c.v_new, static_cast<const int*>(c.pos), static_cast<__nv_bfloat16*>(c.out),
      c.KV, c.G, GB, c.S, c.window, kvd::kLog2e / sqrtf((float)HD), c.cluster);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool BF, bool QW>
int launch_attn_cluster(const void* q, const void* k_c, const void* v_c, const float* ks_c,
                        const float* vs_c, const __nv_bfloat16* k_new,
                        const __nv_bfloat16* v_new, const void* pos, void* out, int B, int KV,
                        int G, int S, int hd, int window, int cluster, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || hd <= 0 || cluster < 1 || cluster > 8 ||
      (long long)cluster * B * KV > 0x7fffffffLL)
    return -1;
  const KvCall c{q, k_c, v_c, ks_c, vs_c, k_new, v_new, pos, out, B, KV, G, S, window, cluster,
                 static_cast<cudaStream_t>(stream)};
  switch (hd) {
#define QTPU_KV_CASE(HD) \
  case HD: return launch_cluster<HD, BF, QW>(c);
    QTPU_HEAD_DIMS(QTPU_KV_CASE)
#undef QTPU_KV_CASE
    default: return -1;
  }
}

}  // namespace

// K2. k_new/v_new [B, 1, KV, hd] bf16, 16-byte aligned; k_c/v_c one layer
// [B, KV, S, hd] int8, 4-byte aligned; ks_c/vs_c [B, KV, S] f32; pos [B]
// int32 on the device, not written by the kernel launched just before this
// one; hd % 8 == 0, hd <= 256. pdl != 0: launched with programmatic stream
// serialization (cudaLaunchKernelEx), so its launch overlaps the tail of
// the kernel before it in the stream (captured into a CUDA graph as a
// programmatic edge); pdl 0: a plain launch of the same kernel.
extern "C" int qtpu_kv_band_write(const void* k_new, const void* v_new, void* k_c,
                                  void* v_c, void* ks_c, void* vs_c, const void* pos,
                                  int B, int KV, int S, int hd, int pdl, void* stream) {
  auto al = [](const void* q, int n) { return reinterpret_cast<uintptr_t>(q) % n == 0; };
  if (B <= 0 || KV <= 0 || S <= 0 || hd <= 0 || hd % 8 != 0 || hd > 256 || !al(k_new, 16) ||
      !al(v_new, 16) || !al(k_c, 4) || !al(v_c, 4))
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * KV));
  cfg.blockDim = dim3(32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, band_write_pdl_kernel, static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<int8_t*>(k_c),
      static_cast<int8_t*>(v_c), static_cast<float*>(ks_c), static_cast<float*>(vs_c),
      static_cast<const int*>(pos), KV, S, hd);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K2's earlier kernel (a plain launch, scalar loads and stores), kept for
// chip_smoke.py's "was" time; the same arguments as qtpu_kv_band_write
// without pdl, any hd.
extern "C" int qtpu_kv_band_write_simt(const void* k_new, const void* v_new, void* k_c,
                                       void* v_c, void* ks_c, void* vs_c, const void* pos,
                                       int B, int KV, int S, int hd, void* stream) {
  if (B <= 0 || KV <= 0 || S <= 0 || hd <= 0) return -1;
  band_write_kernel<<<B * KV, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
      static_cast<int8_t*>(k_c), static_cast<int8_t*>(v_c), static_cast<float*>(ks_c),
      static_cast<float*>(vs_c), static_cast<const int*>(pos), KV, S, hd);
  return (int)cudaGetLastError();
}

// q [B, H, hd] bf16 (H = KV * G, any G, hd a multiple of 8 from 8 to 256);
// cache layer as in qtpu_kv_band_write, 16-byte aligned;
// out [B, H, hd] bf16. window 0 = full causal. cluster: the blocks of one
// (sequence, kv-head), 1 to 8. Returns a cudaError_t (0 on success), -1 for
// arguments the kernel does not take, -2 when no cluster of that size fits.
extern "C" int qtpu_decode_attention(const void* q, const void* k_c, const void* v_c,
                                     const void* ks_c, const void* vs_c, const void* pos,
                                     void* out, int B, int KV, int G, int S, int hd,
                                     int window, int cluster, void* stream) {
  return launch_attn_cluster<false, false>(q, k_c, v_c, static_cast<const float*>(ks_c),
                                           static_cast<const float*>(vs_c), nullptr, nullptr,
                                           pos, out, B, KV, G, S, hd, window, cluster, stream);
}

// K8. q [B, H, hd] bf16; k_new/v_new [B, 1, KV, hd] bf16 (16-byte aligned);
// k_c/v_c one layer [B, KV, S, hd] bf16, written at pos; pos [B] int32; out
// [B, H, hd] bf16; cluster as in qtpu_decode_attention.
extern "C" int qtpu_decode_attention_write_bf16(const void* q, const void* k_new,
                                                const void* v_new, void* k_c, void* v_c,
                                                const void* pos, void* out, int B, int KV,
                                                int G, int S, int hd, int window, int cluster,
                                                void* stream) {
  return launch_attn_cluster<true, false>(q, k_c, v_c, nullptr, nullptr,
                                          static_cast<const __nv_bfloat16*>(k_new),
                                          static_cast<const __nv_bfloat16*>(v_new), pos, out, B,
                                          KV, G, S, hd, window, cluster, stream);
}

// K11. q [B, H, hd] bf16; k_new/v_new [B, 1, KV, hd] bf16; k_c/v_c one layer
// [B, KV, S, hd] int8 and ks_c/vs_c [B, KV, S] f32, written at pos; pos [B]
// int32; out [B, H, hd] bf16; cluster as in qtpu_decode_attention.
extern "C" int qtpu_decode_attention_write(const void* q, const void* k_new, const void* v_new,
                                           void* k_c, void* v_c, void* ks_c, void* vs_c,
                                           const void* pos, void* out, int B, int KV, int G,
                                           int S, int hd, int window, int cluster,
                                           void* stream) {
  return launch_attn_cluster<false, true>(q, k_c, v_c, static_cast<const float*>(ks_c),
                                          static_cast<const float*>(vs_c),
                                          static_cast<const __nv_bfloat16*>(k_new),
                                          static_cast<const __nv_bfloat16*>(v_new), pos, out, B,
                                          KV, G, S, hd, window, cluster, stream);
}

// The earlier body of the three entries above (one block per (sequence,
// kv-head), chunks staged as f32, scalar FMAs), kept for chip_smoke.py's
// "was" times; the same arguments without the cluster, at hd % 16 == 0,
// hd <= 128 and G <= 32.
extern "C" int qtpu_decode_attention_simt(const void* q, const void* k_c, const void* v_c,
                                          const void* ks_c, const void* vs_c, const void* pos,
                                          void* out, int B, int KV, int G, int S, int hd,
                                          int window, void* stream) {
  return launch_attn<false, false>(q, k_c, v_c, static_cast<const float*>(ks_c),
                            static_cast<const float*>(vs_c), nullptr, nullptr, pos, out, B, KV,
                            G, S, hd, window, stream);
}

extern "C" int qtpu_decode_attention_write_bf16_simt(const void* q, const void* k_new,
                                                     const void* v_new, void* k_c, void* v_c,
                                                     const void* pos, void* out, int B, int KV,
                                                     int G, int S, int hd, int window,
                                                     void* stream) {
  return launch_attn<true, false>(q, k_c, v_c, nullptr, nullptr,
                           static_cast<const __nv_bfloat16*>(k_new),
                           static_cast<const __nv_bfloat16*>(v_new), pos, out, B, KV, G, S, hd,
                           window, stream);
}

extern "C" int qtpu_decode_attention_write_simt(const void* q, const void* k_new,
                                                const void* v_new, void* k_c, void* v_c,
                                                void* ks_c, void* vs_c, const void* pos,
                                                void* out, int B, int KV, int G, int S, int hd,
                                                int window, void* stream) {
  return launch_attn<false, true>(q, k_c, v_c, static_cast<const float*>(ks_c),
                                  static_cast<const float*>(vs_c),
                                  static_cast<const __nv_bfloat16*>(k_new),
                                  static_cast<const __nv_bfloat16*>(v_new), pos, out, B, KV, G, S,
                                  hd, window, stream);
}

