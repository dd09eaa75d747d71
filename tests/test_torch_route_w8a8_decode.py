"""K6's decode GEMV and K13's tiles on the tensor cores, checked on the CPU.

Which body K6 (`w8a8_matmul`) runs at M <= 8 is `w8a8_gemv_route` with the
split `w8a8_gemv_split`, the plain-Python mirrors of csrc/w8a8_matmul.cu's
w8a8_gemv_tc_fits; K13 (`layer_boundary`) runs its matmul phases on the
tensor-core step where `boundary_route` (csrc/layer_boundary.cu's
lb_tc_fits) says so, split by `plan`. The kernels run only on the card;
here numpy models of their index maps (the lanes' A and B fragments of
w8a8_gemv_tc_kernel with its byte_perm selectors, mma.sync m16n8k32 as the
PTX ISA lays out its fragments, run_tc_tiles' tile walk) are checked on
random bytes and shapes, so that a wrong map fails here before it reaches
the card. CPU tensors take the plain versions and count no route.
"""

import numpy as np
import pytest
import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import int8_matmul as k6
from qtpu_torch.kernels import layer_boundary as k13
from qtpu_torch.models.config import GPT2_SMALL, LLAMA2_7B, MISTRAL_7B, OPT_125M, TINYLLAMA_1_1B

SMS = 132  # an H100's SMs
ALIGNED = (1 << 20, 2 << 20)  # x and the weight, 16-byte aligned


def _sites(cfg):
    """(K, N) of every W8A8 linear of a decode step of cfg (unfused sites)."""
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    if cfg.arch == "gpt2":
        return {"c_attn": (D, 3 * D), "attn_out": (D, D), "mlp_fc": (D, F),
                "mlp_proj": (F, D), "lm_head": (D, V)}
    if cfg.arch == "opt":
        return {"q_k_v_out": (D, D), "fc1": (D, F), "fc2": (F, D), "lm_head": (D, V)}
    return {"q": (D, cfg.q_dim), "k_v": (D, cfg.kv_dim), "o": (cfg.q_dim, D),
            "gate_up": (D, F), "down": (F, D), "lm_head": (D, V)}


MODELS = {"TinyLlama-1.1B": TINYLLAMA_1_1B, "Llama-2-7B": LLAMA2_7B, "Mistral-7B": MISTRAL_7B,
          "GPT-2": GPT2_SMALL, "OPT-125M": OPT_125M}
SITES = [(m, s, K, N) for m, cfg in MODELS.items() for s, (K, N) in _sites(cfg).items()]
# the one W8A8 decode site the tensor-core GEMV does not take: GPT-2's
# 50257-wide lm_head (N % 16 != 0), which keeps the dp4a body
FALLBACK = {("GPT-2", "lm_head")}


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("model,site,K,N", SITES)
def test_every_w8a8_decode_site_takes_the_tensor_core_gemv(model, site, K, N, M):
    want = "gemv" if (model, site) in FALLBACK else "gemv_tc"
    assert k6.w8a8_route(M, N, ALIGNED) == "gemv"
    assert k6.w8a8_gemv_route(M, K, N, ALIGNED) == want


@pytest.mark.parametrize("model,site,K,N", SITES)
def test_the_cluster_split_covers_k_once(model, site, K, N):
    """Slices of whole 32-row steps, at most 4096 rows (x's stage), a
    cluster of at most 8 blocks (the portable size), every row in one slice
    and no slice empty."""
    if (model, site) in FALLBACK:
        return
    cluster, rows = k6.w8a8_gemv_split(SMS, N, K)
    assert 1 <= cluster <= 8 and rows % 32 == 0 and 32 <= rows <= 4096
    assert (cluster - 1) * rows < K <= cluster * rows
    starts = [z * rows for z in range(cluster)]
    covered = np.zeros(K, int)
    for s in starts:
        covered[s:min(K, s + rows)] += 1
    assert (covered == 1).all()


def test_the_cluster_split_at_tinyllamas_sites():
    """The smallest cluster reaching one block an SM with slices of at most
    2048 rows, else the largest: q/o and k/v 8 x 256 rows, gate/up 4 x 512,
    down 8 x 704, lm_head 1 x 2048."""
    assert k6.w8a8_gemv_split(SMS, 2048, 2048) == (8, 256)
    assert k6.w8a8_gemv_split(SMS, 256, 2048) == (8, 256)
    assert k6.w8a8_gemv_split(SMS, 5632, 2048) == (4, 512)
    assert k6.w8a8_gemv_split(SMS, 2048, 5632) == (8, 704)
    assert k6.w8a8_gemv_split(SMS, 32000, 2048) == (1, 2048)


@pytest.mark.parametrize("M,K,N,ptrs,why", [
    (9, 2048, 2048, ALIGNED, "M > 8"),
    (8, 2048, 2052, ALIGNED, "N % 16 != 0"),
    (8, 1000, 2048, ALIGNED, "K % 32 != 0"),
    (8, 2048, 2048, (ALIGNED[0] + 8, ALIGNED[1]), "x 8 bytes off"),
    (8, 2048, 2048, (ALIGNED[0], ALIGNED[1] + 4), "the weight 4 bytes off"),
    (8, 8 * 4096 + 32, 2048, ALIGNED, "no split of 8 slices of at most 4096 rows"),
])
def test_calls_the_rule_refuses_keep_the_dp4a_body(M, K, N, ptrs, why):
    assert k6.w8a8_gemv_route(M, K, N, ptrs) == "gemv", why


# ------------------------------------------- numpy models of the kernels' maps

def _byte_perm(x, y, s):
    """CUDA's __byte_perm for selectors of nibbles 0-7."""
    src = int(x).to_bytes(4, "little") + int(y).to_bytes(4, "little")
    return int.from_bytes(bytes(src[(s >> (4 * n)) & 7] for n in range(4)), "little")


def _u32(b):
    return int.from_bytes(np.asarray(b, np.int8).tobytes(), "little")


def _s8(word):
    return np.frombuffer(int(word).to_bytes(4, "little"), np.int8).astype(np.int64)


def _mma_m16n8k32(frags):
    """mma.sync.m16n8k32 s8 x s8 -> s32 over a warp's fragments (PTX ISA):
    lane (g, t) holds A rows g (a0: K 4t..4t+3, a2: 16 + 4t..) and g + 8 (a1,
    a3), B column g (b0: K 4t.., b1: 16 + 4t..), and gets C rows g, g + 8 at
    columns 2t, 2t + 1."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane, (a, b) in enumerate(frags):
        g, t = lane >> 2, lane & 3
        A[g, 4 * t:4 * t + 4], A[g + 8, 4 * t:4 * t + 4] = _s8(a[0]), _s8(a[1])
        A[g, 16 + 4 * t:20 + 4 * t], A[g + 8, 16 + 4 * t:20 + 4 * t] = _s8(a[2]), _s8(a[3])
        B[4 * t:4 * t + 4, g], B[16 + 4 * t:20 + 4 * t, g] = _s8(b[0]), _s8(b[1])
    C = A @ B
    return [(C[l >> 2, 2 * (l & 3)], C[l >> 2, 2 * (l & 3) + 1],
             C[(l >> 2) + 8, 2 * (l & 3)], C[(l >> 2) + 8, 2 * (l & 3) + 1]) for l in range(32)]


def _w8tc_warp_step(d, xq):
    """One step of w8a8_gemv_tc_kernel's warp: d int8 [32, 128] (the step's
    K rows of the block's columns), xq int8 [8, 32]. Returns acc[lane][i][e]
    as w8tc_step leaves it."""
    acc = np.zeros((32, 8, 4), np.int64)
    for i in range(8):
        frags = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            # the lane's 8 rows (K 8t .. 8t + 7), word i / 2 of its 16 columns
            wd = [_u32(d[8 * t + r, 16 * g + 4 * (i >> 1):16 * g + 4 * (i >> 1) + 4])
                  for r in range(8)]
            sel = 0x7362 if i & 1 else 0x5140
            p01, p23 = _byte_perm(wd[0], wd[1], sel), _byte_perm(wd[2], wd[3], sel)
            p45, p67 = _byte_perm(wd[4], wd[5], sel), _byte_perm(wd[6], wd[7], sel)
            af = (_byte_perm(p01, p23, 0x5410), _byte_perm(p01, p23, 0x7632),
                  _byte_perm(p45, p67, 0x5410), _byte_perm(p45, p67, 0x7632))
            b = (_u32(xq[g, 8 * t:8 * t + 4]), _u32(xq[g, 8 * t + 4:8 * t + 8]))
            frags.append((af, b))
        for lane, c in enumerate(_mma_m16n8k32(frags)):
            acc[lane, i] += c
    return acc


def _warp_layout(o):
    """(row, column) of output o = (i 4 + e) 32 + lane of a block's 1024
    sums (dq_gemv_tc_kernel's and w8a8_gemv_tc_kernel's epilogue)."""
    ln, i, e = o & 31, o >> 7, (o >> 5) & 3
    return 2 * (ln & 3) + (e & 1), 16 * (ln >> 2) + 2 * i + (e >> 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_k6_fragments_give_the_exact_product_of_a_step(seed):
    """The lanes' A fragments (8 rows by 16-byte loads, the byte_perm
    transposes) and B fragments (one 8-byte load of xq) give exactly
    xq @ d for the step, in the warps' layout the epilogue reads."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-128, 128, (32, 128)).astype(np.int8)
    xq = rng.integers(-127, 128, (8, 32)).astype(np.int8)
    want = xq.astype(np.int64) @ d.astype(np.int64)  # [8 rows, 128 columns]
    acc = _w8tc_warp_step(d, xq)
    for o in range(1024):
        m, n = _warp_layout(o)
        lane, i, e = o & 31, o >> 7, (o >> 5) & 3
        assert acc[lane, i, e] == want[m, n], (o, m, n)


def test_the_warp_layout_covers_a_block_once():
    seen = {_warp_layout(o) for o in range(1024)}
    assert seen == {(m, n) for m in range(8) for n in range(128)}


def test_k13_partial_writes_invert_the_warp_layout():
    """run_tc_tiles reads the sum of (row m, column nl) at
    o = ((nl % 16) / 2 * 4 + e) * 32 + 4 (nl / 16) + m / 2 with
    e = 2 (nl % 2) + m % 2: the inverse of the epilogue's map."""
    for m in range(8):
        for nl in range(128):
            e = (nl & 1) << 1 | (m & 1)
            o = (((nl & 15) >> 1) * 4 + e) * 32 + 4 * (nl >> 4) + (m >> 1)
            assert _warp_layout(o) == (m, nl)


def _tc_tiles(M, K, N, group, per, splits):
    """run_tc_tiles' walk: tile t -> (strip, row tile, slice) -> the
    (column, row tile, group) triples it covers."""
    strips, mt, groups = -(-N // 128), -(-M // 8), K // group
    for t in range(strips * mt * splits):
        strip, tm, z = t % strips, (t // strips) % mt, t // (strips * mt)
        gb, ge = z * per, min(groups, (z + 1) * per)
        yield strip, tm, z, range(strip * 128, min(N, strip * 128 + 128)), range(gb, ge)


K13_LAYERS = {"TinyLlama-1.1B": TINYLLAMA_1_1B, "Llama-2-7B": LLAMA2_7B}


@pytest.mark.parametrize("M", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("bits,group,blocks", [(4, 128, 528), (8, 128, 396), (4, 64, 528)])
@pytest.mark.parametrize("model", sorted(K13_LAYERS))
def test_k13_tile_plan_covers_every_phase_once(model, bits, group, blocks, M):
    """Each phase's tiles (the plan on a grid of `blocks`: 4 or 3 blocks an
    SM) cover every (column, row tile, K group) once, with slices of at most
    TC_SLICE K values; the layer's widths take the tensor-core tiles."""
    cfg = K13_LAYERS[model]
    D, F, Q = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim
    metas = tuple((bits, group, K, N) for K, N in
                  ((Q, D), (D, 2 * F), (F, D), (D, Q + 2 * cfg.kv_dim)))
    assert k13.boundary_route(metas, [1 << 20] * 13) == "gemv_tc"
    for (per, splits), (_, g, K, N) in zip(k13.plan(metas, M, blocks, True), metas):
        assert per * g <= k13.TC_SLICE and (splits - 1) * per < K // g <= splits * per
        seen = np.zeros((N, -(-M // 8), K // g), int)
        for _, tm, _, cols, grps in _tc_tiles(M, K, N, g, per, splits):
            assert len(grps) > 0
            seen[cols.start:cols.stop, tm, grps.start:grps.stop] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("metas,ptrs,why", [
    (((4, 32, 256, 256), (4, 32, 256, 1024), (4, 32, 512, 256), (4, 32, 256, 512)),
     [1 << 20] * 13, "group 32"),
    (((4, 128, 256, 264), (4, 128, 264, 1024), (4, 128, 512, 264), (4, 128, 264, 512)),
     [1 << 20] * 13, "D % 16 != 0"),
    (((4, 128, 256, 256), (4, 128, 256, 1024), (4, 128, 512, 256), (4, 128, 256, 516)),
     [1 << 20] * 13, "Nq % 16 != 0"),
    (((4, 128, 256, 256), (4, 128, 256, 1024), (4, 128, 512, 256), (4, 128, 256, 512)),
     [(1 << 20) + 8] + [1 << 20] * 12, "attn 8 bytes off"),
])
def test_k13_calls_the_rule_refuses_keep_the_dq_tiles(metas, ptrs, why):
    assert k13.boundary_route(metas, ptrs) == "gemv", why


def test_k13_dq_plan_is_the_first_versions():
    """With tc False the plan is the dq_core tiles' as before: 32-column
    tiles, slices of at least 256 K values."""
    metas = ((4, 128, 2048, 2048), (4, 128, 2048, 11264), (4, 128, 5632, 2048),
             (4, 128, 2048, 2560))
    for (per, splits), (_, g, K, N) in zip(k13.plan(metas, 8, 132, False), metas):
        assert per * g >= 256 and (splits - 1) * per < K // g <= splits * per
        assert (per, splits) == k13._slices(K, g, -(-N // 32), 132)


# ------------------------------------------------------- the CPU's plain path

def test_cpu_tensors_take_the_plain_versions_and_count_no_route():
    g = torch.Generator().manual_seed(0)
    K, N = 256, 128
    w8 = quantize_pack(torch.randn(K, N, generator=g) * 0.02, 8, K)
    x = torch.randn(3, K, generator=g).to(torch.bfloat16)
    m6 = (8, K, K, N)

    def counters():
        return (k6.w8a8_matmul.launches, k6.w8a8_matmul.gemv_tc_launches,
                k6.w8a8_matmul.gemv_launches, k6.w8a8_matmul_dp4a.launches,
                k13.layer_boundary.launches, k13.layer_boundary.gemv_tc_launches,
                k13.layer_boundary.gemv_launches, k13.layer_boundary_dq.launches)

    before = counters()
    y = k6.w8a8_matmul(x, w8.data, w8.scales, w8.zeros, m6)
    assert torch.equal(y, k6.w8a8_matmul_plain(x, w8.data, w8.scales, w8.zeros, m6))
    D, F, Q, Nq = 128, 256, 128, 256
    sites = [quantize_pack(torch.randn(Kk, Nn, generator=g) * 0.05, 4, 64)
             for Kk, Nn in ((Q, D), (D, 2 * F), (F, D), (D, Nq))]
    views = [{"data": s.data, "scales": s.scales, "zeros": s.zeros} for s in sites]
    metas = ((4, 64, Q, D), (4, 64, D, 2 * F), (4, 64, F, D), (4, 64, D, Nq))
    attn = torch.randn(2, Q, generator=g).to(torch.bfloat16)
    xr = torch.randn(2, D, generator=g).to(torch.bfloat16)
    nw = torch.ones(D, dtype=torch.bfloat16)
    got = k13.layer_boundary(attn, xr, nw, nw, *views, metas)
    want = k13.layer_boundary_plain(attn, xr, nw, nw, *views, metas)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counters() == before


def test_the_earlier_bodies_entries_take_card_tensors_only():
    g = torch.Generator().manual_seed(0)
    K, N = 256, 128
    w8 = quantize_pack(torch.randn(K, N, generator=g) * 0.02, 8, K)
    x = torch.randn(3, K, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="card only"):
        k6.w8a8_matmul_dp4a(x, w8.data, w8.scales, w8.zeros, (8, K, K, N))
    with pytest.raises(ValueError, match="card only"):
        k13.layer_boundary_dq(x, x, x[0], x[0], *([{}] * 4), ((4, 64, K, K),) * 4)
