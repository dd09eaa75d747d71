// K12: split-S flash decoding on one layer of the int8 KV cache, with the
// in-place write of this step's row.
//
// Replaces three TPU kernels of qtpu/kernels/pallas_kv_attention.py that
// compute one function: pallas_decode_attention_flash (:804, the long-context
// per-layer path at S % 2048 == 0), pallas_decode_attention_write_banded
// (:554, any S % 8) and pallas_decode_attention_write_banded_stacked (:907,
// the same on one layer of a stacked cache). For each (sequence b, kv-head):
//   * scores over the cache rows s < pos (strictly before; with a window
//     also s > pos - window): (q . k_code) * k_scale / sqrt(hd) in f32;
//   * one extra column for this step's token from the UNQUANTIZED new key,
//     (q . k_new) / sqrt(hd) in f32, with its value v_new in f32, when
//     pos < S (pos >= S, an inactive slot, masks it);
//   * softmax over both, out = sum p * v_scale * v_code + p_new * v_new;
//   * the new rows quantized with K2's rounding (absmax / 127 clipped at
//     1e-8, round half to even, clip +-127) and written in place at pos
//     when 0 <= pos < S.
//
// Bound on an H100: the bytes of the cache rows in [pos - window, pos) (int8
// k and v plus two f32 scales a row): 142.6 MB a layer at TinyLlama B 8, KV
// 4, hd 64, S 32768, 42.6 us at 3.35 TB/s. A (sequence, kv-head) per block
// (K3's grid) gives 32 blocks at B 8 on 132 SMs and cannot stream that.
//
// Design: split-KV flash decoding in two launches.
//  1. flash_split_mma_kernel, grid (nsplit, KV, B), 4 warps. Each block
//     takes one contiguous slice of the rows the mask keeps for its sequence
//     (read from pos on the device: slices of rows outside the window are
//     never visited, and no host synchronization is needed) and runs the
//     shared core on it (kv_decode_core.cuh: raw int8 chunks through a
//     cp.async ring, two in flight while a third is computed; q . k and
//     p . v on mma.sync over the codes converted to bf16 in registers, with
//     p * v_scale rounded to bf16 as the TPU kernel does; every cache byte
//     read once per block), then writes (acc[hd], m, l) for each head to an
//     f32 scratch. nsplit is the wrapper's `flash_splits`: at most as many
//     blocks as the card runs at once (qtpu_flash_split_blocks_per_sm), at
//     least 512 rows a slice. The earlier body, flash_split_kernel (one warp per query
//     head, chunks converted to f32 in shared memory and re-read by every
//     warp, scalar FMAs), stays behind qtpu_flash_decode_simt for
//     chip_smoke.py's "was" times; no model path reaches it.
//  2. flash_combine_kernel, grid B * KV: merges the slices, adds the new
//     token's column from k_new / v_new, normalizes, and writes the new rows'
//     codes and scales at pos.
// Head dims: every multiple of 8 from 8 to 256, any G (the shared core's; a
// kv-head with more q heads than a block takes is split over head groups on
// the grid's y axis, each group's blocks reading the same slice).
// No block of either launch reads row pos of the cache: the strict mask
// keeps it out of every slice, so the write in launch 2 cannot race a read
// (and launch 2 follows launch 1 on the stream in any case). Not carried
// over from the TPU kernel: its 2048-row S blocks, the full-block blend of
// the block that owns pos, and the phase-split body (Mosaic workarounds).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kv_decode_core.cuh"

namespace {

constexpr int kChunk = 64;  // cache rows per staged chunk (two per lane)
constexpr int kMaxG = 32;   // warps of a combine block; the earlier split body: one a head

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

// The rows [lo, hi) sequence b attends to in the cache: s < pos, and
// s > pos - window when window > 0.
__device__ __forceinline__ void kept_rows(int p, int S, int window, int* lo, int* hi) {
  *hi = max(0, min(p, S));
  *lo = window > 0 ? max(0, p - window + 1) : 0;
}

// grid (nsplit, KV, B), block G * 32. part: [B, KV, nsplit, G, HD + 2] f32,
// per head the unnormalized output, then m and l (m = -inf, l = 0 for an
// empty slice).
template <int HD>
__global__ void __launch_bounds__(kMaxG * 32) flash_split_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_c,
    const int8_t* __restrict__ v_c, const float* __restrict__ ks_c,
    const float* __restrict__ vs_c, const int* __restrict__ pos, float* __restrict__ part,
    int KV, int G, int S, int window, float sm_scale) {
  constexpr int KLD = HD + 4;  // padded K rows: float4 reads by lanes on distinct rows
  constexpr int VPL = HD / 32;  // output dims per lane, adjacent
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                   // [G][HD]
  float* Ks = qs + G * HD;          // [kChunk][KLD]
  float* Vs = Ks + kChunk * KLD;    // [kChunk][HD]
  float* kss = Vs + kChunk * HD;    // [kChunk]
  float* vss = kss + kChunk;        // [kChunk]
  float* pw = vss + kChunk;         // [G][kChunk], p * v_scale

  const int z = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int g = tid / 32, lane = tid % 32;
  const size_t qoff = ((size_t)b * KV * G + (size_t)kvh * G) * HD;
  for (int i = tid; i < G * HD; i += nthr) qs[i] = __bfloat162float(q[qoff + i]);

  int lo, hi;
  kept_rows(pos[b], S, window, &lo, &hi);
  const int n = max(0, hi - lo);
  const int per = ((n + nsplit - 1) / nsplit + 15) / 16 * 16;
  const int s_beg = lo + z * per;
  const int s_end = min(hi, s_beg + per);
  const size_t row0 = ((size_t)b * KV + kvh) * S;  // first row of this (b, kv-head)

  float o[VPL];
#pragma unroll
  for (int t = 0; t < VPL; ++t) o[t] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int s0 = s_beg; s0 < s_end; s0 += kChunk) {
    const int cn = min(kChunk, s_end - s0);
    __syncthreads();  // the previous chunk (and qs on the first pass) is settled
    const int4* ksrc = reinterpret_cast<const int4*>(k_c + (row0 + s0) * HD);
    const int4* vsrc = reinterpret_cast<const int4*>(v_c + (row0 + s0) * HD);
    for (int i = tid; i < cn * HD / 16; i += nthr) {
      const int s = (16 * i) / HD;
      const int d = 16 * i - s * HD;
      const int4 kw = __ldg(ksrc + i);
      const int4 vw = __ldg(vsrc + i);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&kw);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vw);
#pragma unroll
      for (int t = 0; t < 16; t += 4) {
        *reinterpret_cast<float4*>(Ks + s * KLD + d + t) =
            make_float4(kb[t], kb[t + 1], kb[t + 2], kb[t + 3]);
        *reinterpret_cast<float4*>(Vs + s * HD + d + t) =
            make_float4(vb[t], vb[t + 1], vb[t + 2], vb[t + 3]);
      }
    }
    for (int i = tid; i < cn; i += nthr) {
      kss[i] = ks_c[row0 + s0 + i];
      vss[i] = vs_c[row0 + s0 + i];
    }
    __syncthreads();
    // scores of rows lane and lane + 32 for head g
    float dot[kChunk / 32];
#pragma unroll
    for (int jj = 0; jj < kChunk / 32; ++jj) dot[jj] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(qs + g * HD);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 qv = q4[d4];
#pragma unroll
      for (int jj = 0; jj < kChunk / 32; ++jj) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (lane + 32 * jj) * KLD + 4 * d4);
        dot[jj] = fmaf(qv.x, kv.x, fmaf(qv.y, kv.y, fmaf(qv.z, kv.z, fmaf(qv.w, kv.w, dot[jj]))));
      }
    }
    float sc[kChunk / 32];
    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kChunk / 32; ++jj) {
      const int s = lane + 32 * jj;
      sc[jj] = s < cn ? dot[jj] * kss[s] * sm_scale : -INFINITY;
      cmax = fmaxf(cmax, sc[jj]);
    }
    cmax = warp_max(cmax);  // finite: every row of the slice is kept
    const float mnew = fmaxf(m, cmax);
    const float alpha = expf(m - mnew);  // 0 on the first chunk
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kChunk / 32; ++jj) {
      const int s = lane + 32 * jj;
      if (s < cn) {
        const float e = expf(sc[jj] - mnew);
        psum += e;
        pw[g * kChunk + s] = e * vss[s];
      }
    }
    l = l * alpha + warp_sum(psum);
    m = mnew;
    __syncwarp();
#pragma unroll
    for (int t = 0; t < VPL; ++t) o[t] *= alpha;
    for (int s = 0; s < cn; ++s) {
      const float w = pw[g * kChunk + s];
      const float* vr = Vs + s * HD + VPL * lane;
#pragma unroll
      for (int t = 0; t < VPL; ++t) o[t] = fmaf(w, vr[t], o[t]);
    }
  }
  float* dst = part + ((((size_t)b * KV + kvh) * nsplit + z) * G + g) * (HD + 2);
#pragma unroll
  for (int t = 0; t < VPL; ++t) dst[VPL * lane + t] = o[t];
  if (lane == 0) {
    dst[HD] = m;
    dst[HD + 1] = l;
  }
}


// grid (nsplit, KV * groups, B), block kvd::kThreads: flash_split_kernel's
// slices and scratch on the shared core, each block GB <= 32 of a kv-head's
// G heads (head group blockIdx.y % groups; the last may hold fewer). qk_scale =
// log2(e) / sqrt(hd); the scratch's m is in natural-log units, as
// flash_combine_kernel reads it.
template <int HD>
__global__ void __launch_bounds__(kvd::kThreads) flash_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_c,
    const int8_t* __restrict__ v_c, const float* __restrict__ ks_c,
    const float* __restrict__ vs_c, const int* __restrict__ pos, float* __restrict__ part,
    int KV, int G, int GB, int S, int window, float qk_scale) {
  extern __shared__ __align__(16) float sm[];
  unsigned char* base = kvd::align16(sm);
  const int z = blockIdx.x, nsplit = gridDim.x;
  const int groups = gridDim.y / KV;
  const int kvh = blockIdx.y / groups, h0 = (blockIdx.y - kvh * groups) * GB;
  const int Gb = min(GB, G - h0);
  const int b = blockIdx.z;
  int lo, hi;
  kept_rows(pos[b], S, window, &lo, &hi);
  const int n = max(0, hi - lo);
  const int per = ((n + nsplit - 1) / nsplit + 15) / 16 * 16;
  const int s_beg = lo + z * per;
  const int s_end = max(s_beg, min(hi, s_beg + per));
  const size_t row0 = ((size_t)b * KV + kvh) * S;  // first row of this (b, kv-head)
  kvd::Rows r;
  r.k = reinterpret_cast<const unsigned char*>(k_c + row0 * HD);
  r.v = reinterpret_cast<const unsigned char*>(v_c + row0 * HD);
  r.ks = ks_c + row0;
  r.vs = vs_c + row0;
  r.fresh = -1;  // the strict mask keeps row pos out of every slice
  kvd::attend<HD, false>(base, q + ((size_t)b * KV * G + (size_t)kvh * G + h0) * HD, Gb, r,
                         s_beg, s_end, qk_scale, [] {});
  const float* bacc = reinterpret_cast<const float*>(base + kvd::Layout<HD, false>::BLOCK_OFF);
  const float* bm = bacc + kvd::kMaxG * HD;
  const float* bl = bm + kvd::kMaxG;
  float* dst = part + ((((size_t)b * KV + kvh) * nsplit + z) * G + h0) * (HD + 2);
  for (int i = threadIdx.x; i < Gb * (HD + 2); i += kvd::kThreads) {
    const int h = i / (HD + 2), j = i - h * (HD + 2);
    dst[i] = j < HD ? bacc[h * HD + j] : j == HD ? bm[h] / kvd::kLog2e : bl[h];
  }
}

// K2's rounding of one row of hd values by one warp.
__device__ __forceinline__ void quantize_row(const __nv_bfloat16* src, int8_t* dst, float* scale_out, int hd,
                             int lane) {
  float amax = 0.f;
  for (int i = lane; i < hd; i += 32) amax = fmaxf(amax, fabsf(__bfloat162float(src[i])));
  amax = warp_max(amax);
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
  for (int i = lane; i < hd; i += 32) {
    float v = rintf(__bfloat162float(src[i]) / scale);  // round half to even
    v = fminf(fmaxf(v, -127.f), 127.f);
    dst[i] = (int8_t)v;
  }
  if (lane == 0) *scale_out = scale;
}

// grid B * KV, block min(G, 32) * 32: merges the nsplit slices of each head
// (warp w takes heads w, w + 32, ...) with the new token's column, writes out
// [B, H, HD] bf16, then the new rows at pos. A lane owns VPL adjacent dims
// where HD % 32 == 0 (dim and mine fold to that layout with no test, at
// compile time), else dims lane, lane + 32, ... below HD.
template <int HD>
__global__ void __launch_bounds__(kMaxG * 32) flash_combine_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
    const __nv_bfloat16* __restrict__ v_new, int8_t* k_c, int8_t* v_c, float* ks_c,
    float* vs_c, const int* __restrict__ pos, const float* __restrict__ part,
    __nv_bfloat16* __restrict__ out, int KV, int G, int S, int nsplit, float sm_scale) {
  constexpr int VPL = (HD + 31) / 32;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x - b * KV;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int p = pos[b];
  const size_t nrow = ((size_t)b * KV + kvh) * HD;  // this head's new k/v row
  auto dim = [lane](int t) { return HD % 32 == 0 ? VPL * lane + t : lane + 32 * t; };
  auto mine = [lane](int t) { return HD % 32 == 0 || lane + 32 * t < HD; };
  for (int g = w; g < G; g += nw) {
    const size_t qoff = (((size_t)b * KV + kvh) * G + g) * HD;

    float kn[VPL], vn[VPL];
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < VPL; ++t) {
      const int d = dim(t);
      kn[t] = mine(t) ? __bfloat162float(k_new[nrow + d]) : 0.f;
      vn[t] = mine(t) ? __bfloat162float(v_new[nrow + d]) : 0.f;
      if (mine(t)) dot = fmaf(__bfloat162float(q[qoff + d]), kn[t], dot);
    }
    const float s_new = p < S ? warp_sum(dot) * sm_scale : -INFINITY;

    const float* src = part + (((size_t)b * KV + kvh) * nsplit * G + g) * (HD + 2);
    const size_t stride = (size_t)G * (HD + 2);  // one slice to the next
    float mx = s_new;
    for (int z = 0; z < nsplit; ++z) mx = fmaxf(mx, src[z * stride + HD]);
    float acc[VPL];
    float l = 0.f;
    const float e_new = mx == -INFINITY ? 0.f : expf(s_new - mx);
#pragma unroll
    for (int t = 0; t < VPL; ++t) acc[t] = e_new * vn[t];
    l = e_new;
    if (mx != -INFINITY) {
      for (int z = 0; z < nsplit; ++z) {
        const float* sl = src + z * stride;
        const float mz = sl[HD];
        if (mz == -INFINITY) continue;  // an empty slice
        const float wz = expf(mz - mx);
        l = fmaf(sl[HD + 1], wz, l);
#pragma unroll
        for (int t = 0; t < VPL; ++t)
          if (mine(t)) acc[t] = fmaf(sl[dim(t)], wz, acc[t]);
      }
    }
    const float inv = l > 0.f ? 1.0f / l : 0.f;
#pragma unroll
    for (int t = 0; t < VPL; ++t)
      if (mine(t)) out[qoff + dim(t)] = __float2bfloat16(acc[t] * inv);
  }

  // the new rows at pos (warps 0 and 1; warp 0 alone when G = 1)
  if (p < 0 || p >= S) return;
  const size_t row = ((size_t)b * KV + kvh) * S + p;
  for (int r = w; r < 2; r += nw) {
    if (r == 0)
      quantize_row(k_new + nrow, k_c + row * HD, ks_c + row, HD, lane);
    else
      quantize_row(v_new + nrow, v_c + row * HD, vs_c + row, HD, lane);
  }
}

// Allows flash_split_mma_kernel<HD> its dynamic shared memory (once: this
// instance's record, in this library).
template <int HD>
cudaError_t allow_split_smem() {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_split_mma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kvd::Layout<HD, false>::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  return cudaSuccess;
}

template <int HD>
int split_blocks_per_sm() {
  cudaError_t e = allow_split_smem<HD>();
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_split_mma_kernel<HD>,
                                                    kvd::kThreads, kvd::Layout<HD, false>::SMEM);
  return e == cudaSuccess ? n : -(int)e;
}

// One call of K12.
struct KvfCall {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* k_c;
  void* v_c;
  void* ks_c;
  void* vs_c;
  const void* pos;
  void* part;
  void* out;
  int B, KV, G, S, window, nsplit;
  cudaStream_t st;
};

template <int HD>
int launch(const KvfCall& c) {
  const int G = c.G;
  const int groups = kvd::head_groups(G), GB = kvd::group_heads(G);
  if ((long long)c.KV * groups > 65535) return -1;
  constexpr int smem = kvd::Layout<HD, false>::SMEM;
  cudaError_t e0 = allow_split_smem<HD>();
  if (e0 != cudaSuccess) return (int)e0;
  const float sm_scale = 1.0f / sqrtf((float)HD);
  flash_split_mma_kernel<HD><<<dim3(c.nsplit, c.KV * groups, c.B), kvd::kThreads, smem, c.st>>>(
      static_cast<const __nv_bfloat16*>(c.q), static_cast<const int8_t*>(c.k_c),
      static_cast<const int8_t*>(c.v_c), static_cast<const float*>(c.ks_c),
      static_cast<const float*>(c.vs_c), static_cast<const int*>(c.pos),
      static_cast<float*>(c.part), c.KV, G, GB, c.S, c.window, kvd::kLog2e * sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_combine_kernel<HD><<<c.B * c.KV, (G < kMaxG ? G : kMaxG) * 32, 0, c.st>>>(
      static_cast<const __nv_bfloat16*>(c.q), static_cast<const __nv_bfloat16*>(c.k_new),
      static_cast<const __nv_bfloat16*>(c.v_new), static_cast<int8_t*>(c.k_c),
      static_cast<int8_t*>(c.v_c), static_cast<float*>(c.ks_c), static_cast<float*>(c.vs_c),
      static_cast<const int*>(c.pos), static_cast<const float*>(c.part),
      static_cast<__nv_bfloat16*>(c.out), c.KV, G, c.S, c.nsplit, sm_scale);
  return (int)cudaGetLastError();
}

// What 0 launches K12 (`call` a KvfCall) at head dim hd, what 1 returns
// the split body's blocks an SM there; -1 for an hd it does not take.
int flash_at(int what, int hd, const void* call) {
  switch (hd) {
#define QTPU_FLASH_CASE(HD)                                                                 \
  case HD:                                                                                  \
    return what == 0 ? launch<HD>(*static_cast<const KvfCall*>(call))                       \
                     : split_blocks_per_sm<HD>();
    QTPU_HEAD_DIMS(QTPU_FLASH_CASE)
#undef QTPU_FLASH_CASE
    default: return -1;
  }
}

// The earlier split body (flash_split_kernel) with the same combine.
template <int HD>
int launch_simt(const void* q, const void* k_new, const void* v_new, void* k_c, void* v_c,
                void* ks_c, void* vs_c, const void* pos, void* part, void* out, int B, int KV,
                int G, int S, int window, int nsplit, cudaStream_t st) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = sizeof(float) * ((size_t)G * HD + (size_t)kChunk * (HD + 4) +
                                       (size_t)kChunk * HD + 2 * kChunk + (size_t)G * kChunk);
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_split_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const float sm_scale = 1.0f / sqrtf((float)HD);
  flash_split_kernel<HD><<<dim3(nsplit, KV, B), G * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_c),
      static_cast<const int8_t*>(v_c), static_cast<const float*>(ks_c),
      static_cast<const float*>(vs_c), static_cast<const int*>(pos), static_cast<float*>(part),
      KV, G, S, window, sm_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_combine_kernel<HD><<<B * KV, G * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<int8_t*>(k_c),
      static_cast<int8_t*>(v_c), static_cast<float*>(ks_c), static_cast<float*>(vs_c),
      static_cast<const int*>(pos), static_cast<const float*>(part),
      static_cast<__nv_bfloat16*>(out), KV, G, S, nsplit, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, hd] bf16 (H = KV * G, any G, hd a multiple of 8 from 8 to
// 256); k_new/v_new [B, 1, KV, hd] bf16; k_c/v_c one layer [B, KV, S, hd]
// int8 and ks_c/vs_c [B, KV, S] f32, written at pos; pos [B] int32; part
// an f32 scratch of B * KV * nsplit * G * (hd + 2); out [B, H, hd] bf16.
// window 0 = full causal. Returns a cudaError_t (0 on success), or -1 for
// arguments the kernel does not take.
extern "C" int qtpu_flash_decode(const void* q, const void* k_new, const void* v_new, void* k_c,
                                 void* v_c, void* ks_c, void* vs_c, const void* pos, void* part,
                                 void* out, int B, int KV, int G, int S, int hd, int window,
                                 int nsplit, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || hd <= 0 || window < 0 || nsplit <= 0 ||
      nsplit > 65535 || B > 65535)
    return -1;
  const KvfCall c{q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, part, out, B, KV, G, S, window,
                  nsplit, static_cast<cudaStream_t>(stream)};
  return flash_at(0, hd, &c);
}

// qtpu_flash_decode on the earlier split body, for chip_smoke.py's "was"
// times; the same arguments, at hd 32, 64 or 128 (its lanes own hd / 32
// adjacent dims).
extern "C" int qtpu_flash_decode_simt(const void* q, const void* k_new, const void* v_new,
                                      void* k_c, void* v_c, void* ks_c, void* vs_c,
                                      const void* pos, void* part, void* out, int B, int KV,
                                      int G, int S, int hd, int window, int nsplit,
                                      void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || G > kMaxG || S <= 0 || window < 0 || nsplit <= 0 ||
      nsplit > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_simt<32>(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, part, out, B,
                                    KV, G, S, window, nsplit, st);
    case 64: return launch_simt<64>(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, part, out, B,
                                    KV, G, S, window, nsplit, st);
    case 128: return launch_simt<128>(q, k_new, v_new, k_c, v_c, ks_c, vs_c, pos, part, out, B,
                                      KV, G, S, window, nsplit, st);
    default: return -1;
  }
}

// Blocks of the split body (flash_split_mma_kernel) an SM runs at once at
// head_dim hd: what K12's split rule (flash_splits) sizes its grid by; a
// negative cudaError_t on failure, -1 for an hd it does not take.
extern "C" int qtpu_flash_split_blocks_per_sm(int hd) {
  if (hd <= 0) return -1;
  return flash_at(1, hd, nullptr);
}

