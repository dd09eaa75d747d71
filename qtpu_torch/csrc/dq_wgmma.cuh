// Hopper tensor-core route of K1 (dequant_matmul.cu), K7
// (codebook_matmul.cu) and K9 (moe_matmul.cu, the EXPERTS instances) for
// M > 8: wgmma fed by TMA through mbarriers (the helpers: tma.cuh).
//
// Computes what the TPU kernels compute, _dq_matmul_acc and
// _cb_matmul_kernel (qtpu/kernels/pallas_dequant_matmul.py:68-321):
//   y = sum over groups c of s_c o (x_c @ B_c),
// B_c the exact integer codes minus the zero point (K1, q - z, exact in bf16)
// or the codebook level rounded to bf16 (K7, CB), each group's f32 product
// scaled by its f32 scale before it joins the f32 accumulator. The scale is
// never folded into a bf16 weight (that is the XLA reference's arithmetic).
//
// Bound on an H100: at prefill and eval (M 1024-2048) the multiply-adds,
// 989 TFLOP/s bf16, which only wgmma reaches (mma.sync, dq_mma.cuh, cannot).
//
// Design. A persistent grid (at most one block an SM) walks the 128 x 128
// output tiles; a block walks K one group per stage (g = 64 or 128 K values)
// and its producer runs on into the next tile, so one tile's epilogue
// overlaps the next one's loads. It computes each tile's transpose,
// outT = W[:, tile]T xT, so the weight is wgmma's A operand, in registers,
// and x is B, in shared memory ("weight as A", the usual route for
// mixed-input products):
//  * a ring of 4-6 stages in shared memory (as many as fit in 227 KB), each
//    x [128, g] bf16 in 64-column TMA boxes with the 128-byte swizzle wgmma
//    reads (x is K-major, as B wants it), the packed tile [g / PK, 128]
//    bytes by TMA with the same swizzle, and the group's bf16 scales and
//    uint8 zeros of the tile's columns by bulk copies, all completing on
//    the stage's mbarrier. A producer warpgroup (one thread, its registers
//    given up by setmaxnreg) refills a slot as soon as both consumer
//    warpgroups have released it (a second mbarrier, one arrival a warp);
//  * two consumer warpgroups, weight columns 0-63 and 64-127 of the tile,
//    each running wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate) over
//    the stage's g / 16 K steps with A = its 64 weight columns, dequantized
//    straight into A's register fragments, and B = the stage's x tile;
//  * the dequantization of stage s + 1 runs in the consumer's own warps
//    while the tensor cores run stage s (two fragment buffers, 2 x 32
//    registers at g 128). A thread's two A rows are two adjacent weight
//    columns (the rows' order is ours to choose; the epilogue undoes it), so
//    one 16-bit shared load reads both columns of a packed row: 16 loads a
//    thread a stage at W4 g128. The code becomes bf16 without a float
//    conversion: W4/W2 OR the code into 0x4300 (128 + q) and subtract 128 + z
//    as a bf16 pair, exact; W8 the same in f32; the codebook reads a
//    256-entry table in shared memory that gives both levels of a code
//    byte. "Weight as A" was picked over "weight as B" (dequantize into a
//    swizzled bf16 B tile in shared memory), which a first version of this
//    kernel took: on the H100 it was slower at every site, because the B
//    tile's round trip (32 KB written and 64 KB read a stage) and the
//    hand-off to a dequantizing warpgroup cost more than the 64 fragment
//    registers. What bounds it now: the per-group scale's serial tail
//    (below), the codebook's table reads, and at qkv's 160 tiles on 132 SMs
//    the 28 blocks that take a second tile;
//  * the per-group scale (trap 1): each stage's product lands in a second
//    f32 accumulator (wgmma with scale-d = 0 on the stage's first K step),
//    and the FMA s * grp into the total waits for wgmma.wait_group 0; the
//    next stage's dequantization is issued between the commit and the wait,
//    so it, not the tensor cores, fills the wait, and the two warpgroups'
//    wgmmas interleave on the tensor cores while either one scales. The
//    scale is a per-row factor of outT: two scales a thread. Registers:
//    acc 64 + grp 64 + fragments 64 a thread, under setmaxnreg's 232 for the
//    consumers (40 for the producer: 2 x 128 x 232 + 128 x 40 = 384 x 168);
//    ptxas -v reports no spill;
//  * W4's group-halves layout (trap 2, qtpu/core/packing.py:36-62): packed
//    row j of group c holds K index c*g + j (low nibble) and c*g + g/2 + j
//    (high nibble, excess-8); W2 four quarters; W8 one byte with a -128
//    bias. A stage is one whole group, so x is one contiguous box per 64 K
//    values, and the bytes a thread loads for K step t serve the K steps of
//    every field (g/16 steps from g/(16 PK) rows): the byte layout in memory
//    is unchanged;
//  * TMA's limits (trap 3): the packed rows and zeros are N bytes a row, so
//    the route needs N % 16 == 0 and the bases of the codes, scales and
//    zeros 16-byte aligned; x's rows are K * 2 bytes (K a multiple of g).
//    TMA zero-fills boxes past M and N; the epilogue masks rows >= M and
//    columns >= N, and the bulk copies read only the columns below N;
//  * the tensor maps (trap 4) are encoded per call on the host by
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
//    libraries are built without -lcuda), and passed as __grid_constant__
//    parameters, so a layer's view W[l] needs no cache (host cost:
//    qtpu_dq_map_ns, PERF.md);
//  * which route runs (trap 5) is wgmma_fits below, a rule on M, N, the
//    group and the pointers' alignment; the wrappers mirror it
//    (qtpu_torch/kernels/dequant_matmul.py: dq_route) to count launches per
//    route. A failed encode or launch returns its error, which the wrapper
//    raises: there is no fallback to another body;
//  * K9's expert axis (EXPERTS, a template parameter, so K1's and K7's
//    instances compile as they did): the walk spans E x ceil(M / 128) x
//    ceil(N / 128) tiles, along M first inside one expert's column tile
//    (wg_expert_tile), and a stage is still one whole group of one expert.
//    The experts' leaves follow one another, so the weight's map is 2D over
//    [E K / PK, N] rows and expert e's group s is row e K / g + s of the
//    scales and zeros; a per-expert x is one 2D map over [E M, K] rows (a
//    3D map would zero-fill past M inside each expert, but the epilogue
//    masks those rows anyway), a shared x the [M, K] map of K1.
//  * K1's options (OPT, a template parameter, so the other instances compile
//    as they did; pallas_dequant_matmul.py:385-447): y = [resid +]
//    (rms_norm(x) nw) @ W in one launch at any M > 8. resid is an epilogue,
//    resid[m, n] added to the f32 sum before the one bf16 store. norm_w
//    splits the norm: nw[k] scales the weight's K index, so it is folded
//    into the A fragments as they are dequantized (one bf16 multiply of the
//    exact q - z, two 32-bit loads of nw a K step, all while the previous
//    stage's wgmma runs), and the row factor r_m = 1 / sqrt(mean(x_m^2) +
//    eps) is a per-column factor of outT, applied in the epilogue. Its sum
//    of squares comes from a read-only pass over each landed x tile (the
//    consumer threads two a row, each half of its 128-byte rows, rows past
//    M skipped), also under the previous stage's wgmma; at the tile's end
//    the two threads of a row meet by shuffle and the 128 factors go
//    through shared memory to the epilogue (one named barrier a tile). x is
//    read once and never rewritten. The rounding is bf16((q - z) nw) where
//    the plain version rounds bf16(x r nw): both one bf16 rounding an
//    element, within K1's usual f32 against bf16 difference (the wrapper's
//    tolerance, 2e-2 relative).
// Everything here has internal linkage (an anonymous namespace), so the
// libraries that include it keep their own kernels and launch records.
#pragma once

#include <chrono>

#include "dq_core.cuh"
#include "tma.cuh"

namespace qtpu {
namespace {

constexpr int kWgBM = 128;       // rows of x per block: the N of each warpgroup's wgmma
constexpr int kWgBN = 128;       // output columns per block (two consumer warpgroups of 64)
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kWgAtom = 64;      // K values in one 128-byte swizzled row of x
constexpr int kWgRingMax = 6;
constexpr int kWgSmemMax = 227 * 1024;
// setmaxnreg budget: 2 x 128 x 232 + 128 x 40 = 384 x 168, the registers
// the launch gives a 384-thread block at one block an SM
constexpr int kWgConsumerRegs = 232;
constexpr int kWgProducerRegs = 40;

template <int BITS, int G, bool CB = false>
struct WgLayout {
  static constexpr int PK = 8 / BITS;          // fields per packed byte
  static constexpr int R = G / PK;             // packed rows a group (a stage)
  static constexpr int NA = G / kWgAtom;       // 64-wide K atoms of x a stage
  static constexpr int KSTEPS = G / 16;        // wgmma K steps a stage
  static constexpr int XS = NA * kWgBM * 128;  // bytes of x a stage
  static constexpr int PS = R * kWgBN;         // bytes of packed codes a stage
  // the codebook's byte table, one copy a lane (CB), else a placeholder
  static constexpr int TAB = CB ? 256 * 32 * 4 : 1024;
  static constexpr int FIXED = 1024 + TAB;     // align slack, the table
  // x, codes, the group's bf16 scales and uint8 zeros, the stage's two barriers
  static constexpr int PER_STAGE = XS + PS + kWgBN * 3 + 2 * 8;
  static constexpr int RING = (kWgSmemMax - FIXED) / PER_STAGE < kWgRingMax
                                  ? (kWgSmemMax - FIXED) / PER_STAGE
                                  : kWgRingMax;
  static constexpr int SMEM = FIXED + RING * PER_STAGE;
  static_assert(R % 16 == 0, "a K step never straddles two fields");
  static_assert(PS % 1024 == 0, "each slot's codes start on a 1024-byte swizzle atom");
  static_assert(RING >= 2, "the ring needs two stages");
};

struct WgArgs {
  const __nv_bfloat16* scales;  // [K / G, N] ([E, K / G, N] with EXPERTS)
  const uint8_t* zeros;         // the same in uint8, or nullptr (symmetric; unused with CB)
  const float* cb;              // CB: 16 f32 levels
  __nv_bfloat16* out;           // [M, N] ([E, M, N] with EXPERTS)
  int M, K, N;
  // EXPERTS (K9): the experts, x's map rows between two experts' inputs (M,
  // or 0 for an input all experts share) and the elements between outputs
  int E, x_rows;
  long long o_es;
  // OPT (K1's options): the rms-norm weight [K] and the residual [M, N], each
  // nullptr when absent, and the norm's eps
  const __nv_bfloat16* nw;
  const __nv_bfloat16* resid;
  float eps;
};

// K9's tile t of the expert walk (EXPERTS): expert e, column tile nt and
// row tile mt with t = (e ntn + nt) ntm + mt, along M first inside one
// expert's column tile, so the blocks that run together read the same
// weight columns (one of them from device memory, the rest from L2). Sets
// the tile's first row and column; returns e.
__device__ __forceinline__ int wg_expert_tile(int tile, int ntn, int ntm, int& m0, int& n0) {
  const int r = tile / ntm;
  m0 = (tile - r * ntm) * kWgBM;
  n0 = (r % ntn) * kWgBN;
  return r / ntn;
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers (the fragment
// layout of mma.sync's A for each warp's 16 rows), B K-major in shared
// memory; acc = 0 ignores D's old value (the first K step of a group).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a, uint64_t db,
                                                    int acc) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// keeps the compiler from moving or reusing registers the asynchronous
// wgmma still reads or writes
__device__ __forceinline__ void wg_fence_f32(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two consecutive K values of field p of one weight column as a bf16 pair,
// from pr holding their packed bytes at byte 0 and byte 2: q - z, with
// zz = bf16x2 of 128 + z and zf = 2^23 + z.
template <int BITS>
__device__ __forceinline__ uint32_t wg_pair(uint32_t pr, int p, uint32_t zz, float zf) {
  if constexpr (BITS == 8) {
    const float v0 = __uint_as_float(0x4B000000u | ((pr & 0xFFu) ^ 0x80u)) - zf;  // exact q - z
    const float v1 = __uint_as_float(0x4B000000u | (((pr >> 16) & 0xFFu) ^ 0x80u)) - zf;
    const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    uint32_t f;
    if constexpr (BITS == 4) {
      f = p == 0 ? ((pr & 0x000F000Fu) | 0x43004300u)          // 128 + low nibble
                 : (((pr >> 4) & 0x000F000Fu) ^ 0x43084308u);  // 128 + (high nibble ^ 8)
    } else {
      f = ((pr >> (2 * p)) & 0x00030003u) | 0x43004300u;  // 128 + quarter p
    }
    return bf16x2_sub(f, zz);  // (128 + q) - (128 + z), exact
  }
}

// The thread's A fragments of one stage, a[KSTEPS][4], from the slot's
// packed tile pk ([R rows][128 columns] bytes, 128-byte swizzled by TMA:
// byte (j, n) at j * 128 + ((n / 16) ^ (j % 8)) * 16 + n % 16). A rows are
// weight columns, in an order of our choosing: the thread's two rows,
// lane / 4 and lane / 4 + 8 of its warp's 16, are the adjacent columns nc
// and nc + 1, so one 16-bit load reads both of a packed row. K step t
// covers K 16t .. 16t + 15 of the group, of which the thread holds 2q,
// 2q + 1, 2q + 8, 2q + 9 (q = lane % 4). K index k of the group is field
// k / R of packed row k % R, so rows j0 + {2q, 2q + 1, 2q + 8, 2q + 9} give
// one A fragment per field (K steps (p R + j0) / 16). roff: those 4 rows'
// swizzled offsets of column nc (j0 is a multiple of 16, so the swizzle of
// row j0 + r is r's). The 4 rows a warp reads together (q = 0..3) sit in 4
// different 16-byte chunks: no bank conflict. CB (W4): tab[32 b] holds both
// levels of code byte b as bf16, the low nibble's in the low half and the
// excess-8 high nibble's in the high half, so one 32-bit load gives a byte's
// two fields and one byte_perm pairs two rows; the table is kept 32 times
// over, entry b of lane l at 32 b + l (tab points at the lane's copy), so a
// warp's lookups of random bytes never share a bank.
template <int BITS, bool CB, int G>
__device__ __forceinline__ void wg_dequant(const uint8_t* pk, uint32_t (*a)[4],
                                           const uint32_t* roff, uint32_t zz0, uint32_t zz1,
                                           float zf0, float zf1, const uint32_t* tab) {
  using L = WgLayout<BITS, G>;
  uint32_t h[L::R / 16][4];  // rows j0 + 2q + {0, 1, 8, 9}, columns nc and nc + 1
#pragma unroll
  for (int j0 = 0; j0 < L::R; j0 += 16)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[j0 / 16][i] = *reinterpret_cast<const unsigned short*>(pk + j0 * 128 + roff[i]);
  if constexpr (CB) {
#pragma unroll
    for (int j0 = 0; j0 < L::R; j0 += 16) {
      const uint32_t* r = h[j0 / 16];
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns nc, nc + 1: bytes 0, 1 of each row's pair
        const uint32_t t0 = tab[32 * ((r[0] >> (8 * c)) & 0xFFu)];  // row 2q
        const uint32_t t1 = tab[32 * ((r[1] >> (8 * c)) & 0xFFu)];  // row 2q + 1
        const uint32_t t8 = tab[32 * ((r[2] >> (8 * c)) & 0xFFu)];  // row 2q + 8
        const uint32_t t9 = tab[32 * ((r[3] >> (8 * c)) & 0xFFu)];  // row 2q + 9
        a[j0 / 16][c] = __byte_perm(t0, t1, 0x5410);  // low nibbles: field 0
        a[j0 / 16][2 + c] = __byte_perm(t8, t9, 0x5410);
        a[(L::R + j0) / 16][c] = __byte_perm(t0, t1, 0x7632);  // high nibbles: field 1
        a[(L::R + j0) / 16][2 + c] = __byte_perm(t8, t9, 0x7632);
      }
    }
    return;
  }
#pragma unroll
  for (int j0 = 0; j0 < L::R; j0 += 16) {
    const uint32_t* r = h[j0 / 16];
    // (k, k + 1) pairs at bytes 0 and 2: rows 2q, 2q + 1 (and 2q + 8, 2q + 9)
    const uint32_t c00 = __byte_perm(r[0], r[1], 0x5410);  // column nc, K 2q
    const uint32_t c10 = __byte_perm(r[0], r[1], 0x7531);  // column nc + 1, K 2q
    const uint32_t c08 = __byte_perm(r[2], r[3], 0x5410);  // column nc, K 2q + 8
    const uint32_t c18 = __byte_perm(r[2], r[3], 0x7531);  // column nc + 1, K 2q + 8
#pragma unroll
    for (int p = 0; p < L::PK; ++p) {
      const int t = (p * L::R + j0) / 16;
      a[t][0] = wg_pair<BITS>(c00, p, zz0, zf0);
      a[t][1] = wg_pair<BITS>(c10, p, zz1, zf1);
      a[t][2] = wg_pair<BITS>(c08, p, zz0, zf0);
      a[t][3] = wg_pair<BITS>(c18, p, zz1, zf1);
    }
  }
}

// The thread's A fragments of the block's g-th stage, once its slot has
// landed: the zeros of its two weight columns nc, nc + 1 from the slot, then
// wg_dequant.
template <int BITS, bool CB, int G, bool NW = false>
__device__ __forceinline__ void wg_fragments(const uint8_t* ps, const uint8_t* ss, uint64_t* full,
                                             const uint32_t* tab, const WgArgs& a, int g,
                                             int nc, bool in, const uint32_t* roff,
                                             uint32_t (*dst)[4], int k0 = 0) {
  using L = WgLayout<BITS, G, CB>;
  const int slot = g % L::RING;
  mbar_wait(smem_u32(full + slot), (g / L::RING) & 1);
  uint32_t z0 = 1u << (BITS - 1), z1 = 1u << (BITS - 1);  // symmetric: 2^(BITS-1)
  if (!CB && a.zeros != nullptr && in) {
    const uint32_t zp =
        *reinterpret_cast<const unsigned short*>(ss + slot * (kWgBN * 3) + kWgBN * 2 + nc);
    z0 = zp & 0xFFu;
    z1 = zp >> 8;
  }
  wg_dequant<BITS, CB, G>(ps + slot * L::PS, dst, roff, 0x43004300u | (z0 * 0x10001u),
                          0x43004300u | (z1 * 0x10001u), __uint_as_float(0x4B000000u | z0),
                          __uint_as_float(0x4B000000u | z1), tab);
  if constexpr (NW) {
    // K1's norm_w (OPT): the fragment of K step t holds group K values
    // 16 t + 2q, + 1 (registers 0, 1: columns nc, nc + 1) and 16 t + 2q + 8,
    // + 9 (registers 2, 3); each pair times nw's pair, one bf16 rounding
    if (a.nw != nullptr) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(a.nw + k0) + (threadIdx.x & 3);
#pragma unroll
      for (int t = 0; t < L::KSTEPS; ++t) {
        const uint32_t w01 = __ldg(w + 8 * t), w89 = __ldg(w + 8 * t + 4);
        dst[t][0] = bf16x2_mul(dst[t][0], w01);
        dst[t][1] = bf16x2_mul(dst[t][1], w01);
        dst[t][2] = bf16x2_mul(dst[t][2], w89);
        dst[t][3] = bf16x2_mul(dst[t][3], w89);
      }
    }
  }
}

// The loads of group s of the tile at (m0, n0), the block's g-th stage,
// into ring slot g % RING: x's NA boxes and the packed tile (TMA), the
// group's scales and zeros of the tile's columns (bulk copies; ncol = the
// tile's columns below N, a multiple of 16). m0: the tile's first row in
// x's map; sg: the group's row among the weight's groups. For K1 and K7 they
// are the tile's first row and s; for K9 the expert's rows come first (e M
// + m0 for a per-expert x, and e K / g + s, since the experts' codes, scales
// and zeros follow one another in their [E, ...] leaves).
template <int BITS, bool CB, int G>
__device__ __forceinline__ void wg_issue(const CUtensorMap* tmx, const CUtensorMap* tmw,
                                         const WgArgs& a, uint8_t* xs, uint8_t* ps,
                                         uint8_t* ss, uint64_t* full, int g, int s, int m0,
                                         int n0, int ncol, int sg) {
  using L = WgLayout<BITS, G, CB>;
  const int slot = g % L::RING;
  const uint32_t bar = smem_u32(full + slot);
  const bool zeros = a.zeros != nullptr;
  mbar_expect_tx(bar, L::XS + L::PS + ncol * (zeros ? 3 : 2));
#pragma unroll
  for (int at = 0; at < L::NA; ++at)
    tma_load_2d(smem_u32(xs + slot * L::XS + at * kWgBM * 128), tmx, bar, s * G + at * kWgAtom,
                m0);
  tma_load_2d(smem_u32(ps + slot * L::PS), tmw, bar, n0, sg * L::R);
  uint8_t* sz = ss + slot * (kWgBN * 3);  // [128] bf16 scales, then [128] uint8 zeros
  bulk_load(smem_u32(sz), a.scales + (size_t)sg * a.N + n0, ncol * 2, bar);
  if (zeros) bulk_load(smem_u32(sz + kWgBN * 2), a.zeros + (size_t)sg * a.N + n0, ncol, bar);
}

// The 256 consumer threads meet (named barrier 1; the producer never
// joins it).
__device__ __forceinline__ void wg_consumers_sync() {
  asm volatile("barrier.sync 1, 256;\n" ::: "memory");
}

// OPT's norm_w: consumer thread tid's sum of x^2 over its half of x row
// tid / 2 of one landed stage (xt: NA swizzled atoms of [128 rows][128
// bytes]; 16-byte chunk c of a row at position c ^ (row % 8)), 0 for rows
// at or past `rows` (TMA's zero fill). Read only. The chunks are visited in
// logical order, so a warp's 32 lanes at one step hit 8 positions of 16
// bytes: 4 wavefronts, no more than the bytes need.
template <int G>
__device__ __forceinline__ float wg_row_sq(const uint8_t* xt, int tid, int rows) {
  constexpr int CH = G / 16;  // 16-byte chunks a thread: half of a row's G / 8
  const int row = tid >> 1;
  float sq = 0.f;
  if (row >= rows) return sq;
  const int c0 = (tid & 1) * CH;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = c0 + i;
    const uint4 v = *reinterpret_cast<const uint4*>(xt + (c >> 3) * kWgBM * 128 + row * 128 +
                                                    (((c & 7) ^ (row & 7)) << 4));
    const uint32_t* xv = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xv[j]));
      sq = fmaf(xf.x, xf.x, sq);
      sq = fmaf(xf.y, xf.y, sq);
    }
  }
  return sq;
}

// A block is persistent: it walks the 128 x 128 output tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (a grid of at most one block an SM), its
// producer running ahead across tile boundaries, so one tile's epilogue and
// the next one's first loads overlap. It computes each tile
// out[m0 .. m0 + 127, n0 .. n0 + 127] as its transpose:
// consumer warpgroup w holds outT rows n0 + 64 w .. + 63 (weight columns)
// by all 128 x rows, outT = W[:, cols]T xT, with the dequantized weight as
// wgmma's A operand in registers and x's tile, K-major as TMA lays it, as B.
// Barriers a ring slot completes: full (TMA and bulk bytes landed) and
// xempty (the stage consumed: the 8 consumer warps). EXPERTS (K9) adds an
// expert axis to the walk: E x ceil(M / 128) x ceil(N / 128) tiles, each
// one expert's (wg_expert_tile); the weight's map spans the experts' rows
// [E K / PK, N], x's map [E M, K] rows for per-expert inputs (a tile's
// rows past M read the next expert's rows or TMA's zeros, and the epilogue
// masks them) or [M, K] for a shared one, and the output pointer moves by
// the expert's stride. OPT (K1's options, see the note above): a.nw's
// rewrite of each stage's x and its row factors in the epilogue, a.resid
// added there; either may be absent.
template <int BITS, bool CB, int G, bool EXPERTS, bool OPT = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw, WgArgs a) {
  using L = WgLayout<BITS, G, CB>;
  static_assert(!OPT || (!CB && !EXPERTS), "the options are K1's");
  extern __shared__ uint8_t wg_smem[];  // aligned to 1024 below (an __align__ here would move
                                        // the dynamic shared memory of every kernel in the file)
  uint8_t* xs = wg_smem + ((1024 - (smem_u32(wg_smem) & 1023)) & 1023);
  uint8_t* ps = xs + L::RING * L::XS;
  uint8_t* ss = ps + L::RING * L::PS;
  uint32_t* tab = reinterpret_cast<uint32_t*>(ss + L::RING * kWgBN * 3);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + L::TAB / 4);
  uint64_t* xempty = full + L::RING;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ntn = (a.N + kWgBN - 1) / kWgBN;  // tiles along N; tile t is (t / ntn, t % ntn)
  const int ntm = (a.M + kWgBM - 1) / kWgBM;  // EXPERTS: tiles along M (wg_expert_tile)
  int ntiles = ntn * ((a.M + kWgBM - 1) / kWgBM);
  if constexpr (EXPERTS) ntiles *= a.E;
  const int stages = a.K / G;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < L::RING; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(xempty + i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CB && tid < 256) {  // code byte tid's two levels (low nibble, excess-8 high), 32 copies
    const __nv_bfloat162 v2 =
        __floats2bfloat162_rn(a.cb[tid & 15], a.cb[((unsigned)tid >> 4) ^ 8u]);
    const uint32_t v = *reinterpret_cast<const uint32_t*>(&v2);
#pragma unroll
    for (int l = 0; l < 32; l += 4)
      *reinterpret_cast<uint4*>(tab + 32 * tid + l) = make_uint4(v, v, v, v);
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, refilling a slot as
    // soon as both consumer warpgroups are done with its stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (tid == 256) {
      int g = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        int m0 = (tile / ntn) * kWgBM;
        int n0 = (tile % ntn) * kWgBN;
        int xrow = m0, sg0 = 0;  // the tile's first row of x's map, its expert's first group
        if constexpr (EXPERTS) {
          const int e = wg_expert_tile(tile, ntn, ntm, m0, n0);
          xrow = e * a.x_rows + m0;
          sg0 = e * stages;
        }
        const int ncol = a.N - n0 < kWgBN ? a.N - n0 : kWgBN;
        for (int s = 0; s < stages; ++s, ++g) {
          if (g >= L::RING) mbar_wait(smem_u32(xempty + g % L::RING), (g / L::RING - 1) & 1);
          wg_issue<BITS, CB, G>(&tmx, &tmw, a, xs, ps, ss, full, g, s, xrow, n0, ncol, sg0 + s);
        }
      }
    }
  } else {
    // ---- consumer warpgroups. Each dequantizes the next stage's A
    // fragments while its wgmma runs; the two warpgroups' wgmmas interleave
    // on the tensor cores, so one's scaling tail overlaps the other's product.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
    const int lane = tid & 31;
    const int q = lane & 3;
    const uint32_t* ltab = tab + lane;  // the lane's copy of the codebook's byte table
    // the thread's weight columns nc, nc + 1 (its warp's A rows lane / 4 and
    // lane / 4 + 8) and the swizzled offsets of packed rows 2q + {0, 1, 8, 9}
    const int nc = wg * 64 + ((tid >> 5) & 3) * 16 + 2 * (lane >> 2);
    uint32_t roff[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 2 * q + (i & 1) + 8 * (i >> 1);
      roff[i] = r * 128 + ((((nc >> 4) ^ r) & 7) << 4) + (nc & 15);
    }
    // a column is in a tile when below its ncol (a multiple of 16: nc + 1 too)
    auto in_tile = [&](int tile) {
      if constexpr (EXPERTS) tile /= ntm;  // the expert walk's column tile is (t / ntm) % ntn
      return (tile % ntn) * kWgBN + nc < a.N;
    };
    float acc[64];
    float grp[64];
    uint32_t afr[2][L::KSTEPS][4];
    int g = 0;             // the block's stages so far (ring slot and barrier phase)
    bool staged = false;   // afr[0] holds this tile's first fragments already
    // OPT with norm_w: the sums of x^2 of the thread's half row, this tile's
    // and the next one's (its first stage lands while this one ends); the
    // tile's 128 row factors go through rf (the table's room, unused without
    // CB)
    const bool norm = OPT && a.nw != nullptr;
    float* rf = reinterpret_cast<float*>(tab);
    float sq = 0.f, sq_next = 0.f;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      int m0 = (tile / ntn) * kWgBM;
      int n0 = (tile % ntn) * kWgBN;
      __nv_bfloat16* out = a.out;
      if constexpr (EXPERTS) out += (size_t)wg_expert_tile(tile, ntn, ntm, m0, n0) * a.o_es;
      const bool in = in_tile(tile);
      const int next = tile + gridDim.x;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      if (!staged) {
        wg_fragments<BITS, CB, G, OPT>(ps, ss, full, ltab, a, g, nc, in, roff, afr[0]);
        if (norm) sq += wg_row_sq<G>(xs + (g % L::RING) * L::XS, tid, a.M - m0);
      }
      staged = false;
      // two stages an iteration, so each one's fragment buffer is a constant
      // index (a register array indexed at run time would live in local memory)
      for (int s0 = 0; s0 < stages; s0 += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = s0 + h;
          if (s >= stages) break;
          const int slot = (g + s) % L::RING;
          const uint32_t xa = smem_u32(xs + slot * L::XS);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int t = 0; t < L::KSTEPS; ++t)
            wgmma_rs_m64n128k16(grp, afr[h][t],
                                wg_desc(xa + (t / 4) * kWgBM * 128 + (t % 4) * 32), t > 0);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the next stage's fragments while this one runs on the tensor
          // cores: this tile's, or the next tile's first when the stage count
          // is even (its buffer, afr[0], is then free)
          // (OPT with norm_w: the landed stage's sums of x^2 too, this tile's
          // or the next one's)
          if (s + 1 < stages) {
            wg_fragments<BITS, CB, G, OPT>(ps, ss, full, ltab, a, g + s + 1, nc, in, roff,
                                           afr[h ^ 1], (s + 1) * G);
            if (norm) sq += wg_row_sq<G>(xs + ((g + s + 1) % L::RING) * L::XS, tid, a.M - m0);
          } else if (h == 1 && next < ntiles) {
            wg_fragments<BITS, CB, G, OPT>(ps, ss, full, ltab, a, g + s + 1, nc, in_tile(next),
                                           roff, afr[0], 0);
            staged = true;
            if (norm)
              sq_next += wg_row_sq<G>(xs + ((g + s + 1) % L::RING) * L::XS, tid,
                                      a.M - (next / ntn) * kWgBM);
          }
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          wg_fence_f32(grp);
          wg_fence_u32<L::KSTEPS * 4>(&afr[h][0][0]);
          // the group's f32 scales of the thread's two rows (columns nc, nc + 1)
          const float2 sv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(ss + slot * (kWgBN * 3) + 2 * nc));
          warp_arrive(smem_u32(xempty + slot));
#pragma unroll
          for (int jm = 0; jm < 16; ++jm) {
            acc[4 * jm] = fmaf(sv.x, grp[4 * jm], acc[4 * jm]);
            acc[4 * jm + 1] = fmaf(sv.x, grp[4 * jm + 1], acc[4 * jm + 1]);
            acc[4 * jm + 2] = fmaf(sv.y, grp[4 * jm + 2], acc[4 * jm + 2]);
            acc[4 * jm + 3] = fmaf(sv.y, grp[4 * jm + 3], acc[4 * jm + 3]);
          }
        }
      }
      g += stages;
      if (norm) {  // the tile's row factors, from the two half rows' sums
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        if ((tid & 1) == 0) rf[tid >> 1] = 1.0f / sqrtf(sq / (float)a.K + a.eps);
        wg_consumers_sync();
        sq = sq_next;
        sq_next = 0.f;
      }
      // outT fragment: rows lane / 4 and lane / 4 + 8 (columns nc, nc + 1),
      // columns (x rows) 8 jm + 2 q + {0, 1}: one bf16 pair a store
      if (in) {
        // OPT: the residual pairs of half the tile's rows, all loaded before
        // that half's first store (the compiler cannot tell resid from out,
        // so a load after a store would wait for it: one latency a pair)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t rv[OPT ? 16 : 1];
          if constexpr (OPT) {
            if (a.resid != nullptr) {
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                const int row = m0 + 64 * half + 8 * (i >> 1) + 2 * q + (i & 1);
                rv[i] = row < a.M ? __ldg(reinterpret_cast<const unsigned int*>(
                                        a.resid + (size_t)row * a.N + n0 + nc))
                                  : 0u;
              }
            }
          }
#pragma unroll
          for (int jh = 0; jh < 8; ++jh) {
            const int jm = 8 * half + jh;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = m0 + 8 * jm + 2 * q + e;
              if (row < a.M) {
                float v0 = acc[4 * jm + e], v1 = acc[4 * jm + 2 + e];
                if constexpr (OPT) {
                  if (norm) {
                    const float r = rf[8 * jm + 2 * q + e];
                    v0 *= r;
                    v1 *= r;
                  }
                  if (a.resid != nullptr) {
                    const float2 r2 = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&rv[2 * jh + e]));
                    v0 += r2.x;
                    v1 += r2.y;
                  }
                }
                *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * a.N + n0 + nc) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host

// x's map (bf16 [M, K], 64 x 128 boxes) and the packed weight's ([K / PK,
// N] bytes, 128 x R boxes), both with the 128-byte swizzle. With E experts
// (K9) the weight's map spans the E experts' [K / PK, N] rows one after
// another, and x's the E inputs' rows when x_rows (= M) is not 0.
template <int BITS, int G>
int wg_maps(const DqArgs& a, int E, int x_rows, CUtensorMap* tmx, CUtensorMap* tmw) {
  using L = WgLayout<BITS, G>;
  const int rc = encode_2d(tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.K,
                           x_rows ? (uint64_t)E * x_rows : (uint64_t)a.M, (uint64_t)a.K * 2,
                           kWgAtom, kWgBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  return encode_2d(tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.data, a.N, (uint64_t)E * (a.K / L::PK),
                   a.ldw, kWgBN, L::R, CU_TENSOR_MAP_SWIZZLE_128B);
}

// One launch of the route: K1 and K7 (EXPERTS false, E 1, x_rows 0) or K9's
// E experts, whose [E, ...] leaves follow one another (x_rows: M for an
// [E, M, K] input, 0 for a shared [M, K] one).
template <int BITS, bool CB, int G, bool EXPERTS, bool OPT = false>
int launch_wg(const DqArgs& a, int E, int x_rows, cudaStream_t st) {
  using L = WgLayout<BITS, G, CB>;
  static bool smem_set = false;  // this instance's shared-memory attribute
  CUtensorMap tmx, tmw;
  const int rc = wg_maps<BITS, G>(a, E, x_rows, &tmx, &tmw);
  if (rc != 0) return rc;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(dq_wgmma_kernel<BITS, CB, G, EXPERTS, OPT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               L::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  WgArgs w{};
  w.scales = a.scales;
  w.zeros = a.zeros;
  w.cb = a.cb;
  w.out = a.out;
  w.M = a.M;
  w.K = a.K;
  w.N = a.N;
  w.E = E;
  w.x_rows = x_rows;
  w.o_es = (long long)a.M * a.N;
  w.nw = a.nw;
  w.resid = a.resid;
  w.eps = a.eps;
  const long long tiles =
      (long long)E * ((a.N + kWgBN - 1) / kWgBN) * ((a.M + kWgBM - 1) / kWgBM);
  if (tiles > INT32_MAX) return -1;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  dq_wgmma_kernel<BITS, CB, G, EXPERTS, OPT>
      <<<tiles < sms ? (int)tiles : sms, kWgThreads, L::SMEM, st>>>(tmx, tmw, w);
  return (int)cudaGetLastError();
}

// The route rule: the wgmma route takes a call with more than 8 rows, one
// whole group of 64 or 128 K values a stage, rows TMA and the bulk copies can
// stride (N % 16 == 0, a plain [K / PK, N] weight) and every base (x, codes,
// scales, zeros) 16-byte aligned; every other call keeps dq_mma_body or the
// GEMV. Mirrored by dq_route in qtpu_torch/kernels/dequant_matmul.py.
bool wgmma_fits(const DqArgs& a) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return a.M > 8 && (a.group == 64 || a.group == 128) && a.N % 16 == 0 && a.ldw == a.N &&
         a.K % a.group == 0 && a.split_groups == a.K / a.group && aligned(a.x) &&
         aligned(a.data) && aligned(a.scales) && (a.zeros == nullptr || aligned(a.zeros));
}

// Launches the wgmma route for a call wgmma_fits takes; OPT: K1 with its
// options (a.nw, a.resid).
template <int BITS, bool CB, bool OPT = false>
int launch_dq_wgmma(const DqArgs& a, cudaStream_t st) {
  return a.group == 64 ? launch_wg<BITS, CB, 64, false, OPT>(a, 1, 0, st)
                       : launch_wg<BITS, CB, 128, false, OPT>(a, 1, 0, st);
}

// Launches K9's E experts on the route, a being the first expert's view
// (wgmma_fits holds on it) and x_rows M for a per-expert input, else 0.
template <int BITS>
int launch_moe_wgmma(const DqArgs& a, int E, int x_rows, cudaStream_t st) {
  return a.group == 64 ? launch_wg<BITS, false, 64, true>(a, E, x_rows, st)
                       : launch_wg<BITS, false, 128, true>(a, E, x_rows, st);
}

// Host nanoseconds to encode the two tensor maps of one call (the route's
// per-call host cost), the mean over `reps` encodes.
template <int BITS>
long long wgmma_map_ns(const DqArgs& a, int reps) {
  CUtensorMap tmx, tmw;
  if (tmap_encoder() == nullptr || reps <= 0) return -1;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (wg_maps<BITS, 128>(a, 1, 0, &tmx, &tmw) != 0) return -1;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() / reps;
}

}  // namespace
}  // namespace qtpu
