"""Which decode GEMV K1, K7, K9 and K4 launch at M <= 8, and which body K5
launches, on the card: `gemv_route` / `gemv_split` (csrc/dq_gemv_tc.cuh:
gemv_tc_fits, with the wrappers' split of K over a thread-block cluster),
`mlp_route` (K4's two phases) and `flash_route` / `flash_tiles`
(csrc/flash_attention.cu: flash_wgmma_fits and the key-tile loop), the
plain-Python mirrors of the kernels' own rules:

  "gemv_tc"  M <= 8, W4 or W8, group 64 or 128, N and the row pitch
             multiples of 16, codes, scales and zeros 16-byte aligned, and
             a split of K into 1 to 8 slices of whole groups with x's
             slice at most 4096 values: the tensor-core GEMV, one launch
  "gemv"     the rest at M <= 8 (W2, other groups, ragged N, unaligned
             tensors): dq_core's GEMV
  K5 "wgmma" q, k and v 16-byte aligned with strides of whole 16-byte units
     "mma"   the rest (the mma.sync body)

The kernels run only on the card (tests/test_torch_gpu.py holds the route
counters to the kernel the profiler saw); here a CPU tensor takes the plain
version and counts no route.
"""

import pytest
import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import codebook_matmul as k7
from qtpu_torch.kernels import dequant_matmul as k1
from qtpu_torch.kernels import flash_attention as k5
from qtpu_torch.kernels import fused_mlp as k4
from qtpu_torch.kernels import moe_matmul as k9
from qtpu_torch.kernels.flash_attention import attention_mask, flash_tile_masked, flash_tiles
from qtpu_torch.models.config import (GPT2_SMALL, MISTRAL_7B, MIXTRAL_8X7B, OPT_125M,
                                      QWEN2_MOE_A14B, TINYLLAMA_1_1B)

ALIGNED = (1 << 20, 1 << 21, 1 << 22)  # 16-byte aligned codes, scales, zeros
SMS = 132  # an H100 SXM


def _dense_sites(c, fused=True):
    """(K, N) of a dense model's decode sites, fused as the port packs them."""
    qkv = c.q_dim + 2 * c.kv_dim
    sites = {"o": (c.q_dim, c.hidden_size), "down": (c.intermediate_size, c.hidden_size),
             "lm_head": (c.hidden_size, c.vocab_size)}
    if fused:
        sites.update(qkv=(c.hidden_size, qkv), gateup=(c.hidden_size, 2 * c.intermediate_size))
    else:
        sites.update(q=(c.hidden_size, c.q_dim), kv=(c.hidden_size, c.kv_dim),
                     up=(c.hidden_size, c.intermediate_size))
    return sites


# every M <= 8 site of the paths the port serves: name -> (E, K, N)
SITES = {
    **{f"tinyllama_{n}": (1, *kn) for n, kn in _dense_sites(TINYLLAMA_1_1B).items()},
    **{f"gpt2_{n}": (1, *kn) for n, kn in _dense_sites(GPT2_SMALL).items()},
    **{f"opt_{n}": (1, *kn) for n, kn in _dense_sites(OPT_125M).items()},
    **{f"mixtral_{n}": (1, *kn) for n, kn in _dense_sites(MIXTRAL_8X7B, fused=False).items()
       if n != "up" and n != "down"},
    "mixtral_expert_gate_up": (8, MIXTRAL_8X7B.hidden_size, MIXTRAL_8X7B.intermediate_size),
    "mixtral_expert_down": (8, MIXTRAL_8X7B.intermediate_size, MIXTRAL_8X7B.hidden_size),
    "qwen2_57b_expert_gate_up": (64, QWEN2_MOE_A14B.hidden_size,
                                 QWEN2_MOE_A14B.intermediate_size),
    "qwen2_57b_expert_down": (64, QWEN2_MOE_A14B.intermediate_size,
                              QWEN2_MOE_A14B.hidden_size),
}
# the two ragged lm_heads: GPT-2's 50257 columns keep dq_core's VEC = false
# build; OPT's 50272 are 16-aligned (a partial last strip of 128)
RAGGED = {"gpt2_lm_head"}


def test_the_sites_are_the_published_widths():
    assert SITES["tinyllama_qkv"] == (1, 2048, 2560) and SITES["tinyllama_down"] == (1, 5632, 2048)
    assert SITES["gpt2_lm_head"] == (1, 768, 50257) and SITES["opt_lm_head"] == (1, 768, 50272)
    assert SITES["mixtral_expert_down"] == (8, 14336, 4096)
    assert SITES["qwen2_57b_expert_gate_up"] == (64, 3584, 2560)


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("site", sorted(SITES))
def test_every_decode_site_takes_the_tensor_core_gemv_but_ragged_n(site, M):
    E, K, N = SITES[site]
    want = "gemv" if site in RAGGED else "gemv_tc"
    assert k1.dq_route(M, N, 4, 128, ALIGNED) == "gemv"  # the M <= 8 side of K1's rule
    assert k1.gemv_route(M, K, N, 4, 128, ALIGNED) == want
    assert k1.gemv_route(M, K, N, 8, 64, ALIGNED) == want  # W8 g64 too
    assert k7.cb_route(M, N, 128, ALIGNED) == "gemv"
    if E > 1:
        assert k9.moe_route(M, K, N, 4, 128, ALIGNED, per_expert_input=True) == "gemv"


@pytest.mark.parametrize("bits,group,N,ptrs,why", [
    (2, 128, 2560, ALIGNED, "W2 keeps dq_core"),
    (4, 32, 2560, ALIGNED, "a group of 32"),
    (4, 256, 2560, ALIGNED, "a group of 256"),
    (4, 128, 50257, ALIGNED, "ragged N"),
    (4, 128, 2056, ALIGNED, "N % 16 != 0"),
    (4, 128, 2560, (1 << 20, (1 << 21) + 8, 1 << 22), "scales 8-byte aligned"),
    (4, 128, 2560, ((1 << 20) + 4, 1 << 21), "codes 4-byte aligned"),
])
def test_calls_the_body_does_not_take_keep_dq_core(bits, group, N, ptrs, why):
    assert k1.gemv_route(8, 2048, N, bits, group, ptrs) == "gemv", why


def test_rows_past_8_are_not_the_gemvs():
    assert k1.gemv_route(9, 2048, 2560, 4, 128, ALIGNED) == "gemv"
    assert k1.gemv_route(0, 2048, 2560, 4, 128, ALIGNED) == "gemv"


def test_k4_takes_the_body_on_both_phases_or_neither():
    T = TINYLLAMA_1_1B
    D, F = T.hidden_size, T.intermediate_size
    assert k4.mlp_route(8, (4, 128, D, 2 * F), (4, 128, F, D), ALIGNED, ALIGNED) == "gemv_tc"
    # an up column set that starts off a 16-byte boundary (F % 16 != 0)
    assert k4.mlp_route(8, (4, 128, 1024, 2 * 1000), (4, 128, 1000, 1024),
                        ALIGNED, ALIGNED) == "gemv"
    # a misaligned down site sends both phases to dq_core
    assert k4.mlp_route(8, (4, 128, D, 2 * F), (4, 128, F, D), ALIGNED,
                        (1 << 20, (1 << 21) + 2, 1 << 22)) == "gemv"
    assert k4.mlp_route(9, (4, 128, D, 2 * F), (4, 128, F, D), ALIGNED, ALIGNED) == "gemv"


@pytest.mark.parametrize("site", sorted(set(SITES) - RAGGED))
def test_the_cluster_split_covers_the_groups_once_and_fills_the_card(site):
    E, K, N = SITES[site]
    tiles = E * -(-N // k1.GEMV_TC_COLS)
    for group in (64, 128):
        groups = K // group
        c, per = k1.gemv_split(SMS, tiles, groups, group)
        assert 1 <= c <= 8
        slices = [range(r * per, min(groups, (r + 1) * per)) for r in range(c)]
        assert all(len(s) > 0 for s in slices)  # no block without work
        assert sorted(g for s in slices for g in s) == list(range(groups))  # each group once
        assert per * group <= k1.GEMV_TC_X_CAP  # x's slice fits the block's shared memory
        # two blocks an SM where a cluster of 1, 2, 4 or 8 gives them, else the
        # largest cluster whose slices all hold a group
        largest = max(x for x in range(1, 9) if -(-groups // x) * (x - 1) < groups
                      and -(-groups // x) * group <= k1.GEMV_TC_X_CAP)
        assert (tiles * c >= 2 * SMS and c in (1, 2, 4, 8)) or c == largest


def test_the_split_of_the_main_sites():
    # one launch each: K in 8 slices of 2 groups at TinyLlama's qkv, 16-group
    # slices for Mixtral's gate/up across 896 strips, 8 of 14 at its down
    assert k1.gemv_split(SMS, 20, 16, 128) == (8, 2)
    assert k1.gemv_split(SMS, 8 * 112, 32, 128) == (2, 16)
    assert k1.gemv_split(SMS, 8 * 32, 112, 128) == (8, 14)
    assert k1.gemv_split(SMS, 88, 16, 128) == (4, 4)  # TinyLlama's fused gate|up
    assert k1.gemv_split(SMS, 250, 16, 128) == (2, 8)  # TinyLlama's lm_head
    assert k1.gemv_split(SMS, 18, 6, 128) == (6, 1)  # GPT-2's qkv: one group a block
    assert k1.gemv_split(SMS, 1, 2, 128) == (2, 1)
    assert k1.gemv_split(SMS, 1, 1000, 128) is None  # x's slice past the cap at 8 blocks


def _packed(K, N, bits=4, group=128, E=None):
    g = torch.Generator().manual_seed(0)
    mk = lambda: quantize_pack(torch.randn(K, N, generator=g) * 0.02, bits, group)  # noqa: E731
    if E is None:
        return mk()
    parts = [mk() for _ in range(E)]
    return tuple(torch.stack([getattr(p, f) for p in parts]) for f in ("data", "scales", "zeros"))


def _counters(*wrappers):
    names = ("launches", "wgmma_launches", "mma_launches", "gemv_tc_launches", "gemv_launches")
    return [getattr(w, n) for w in wrappers for n in names if hasattr(w, n)]


def test_cpu_tensors_take_the_plain_versions_and_count_no_route():
    K, N, F = 256, 128, 256
    x = torch.randn(8, K).to(torch.bfloat16)
    qt = _packed(K, N)
    e = _packed(K, N, E=2)
    gu, dn = _packed(K, 2 * F), _packed(F, K)
    nw = torch.ones(K, dtype=torch.bfloat16)
    wrappers = (k1.quantized_matmul, k7.codebook_matmul, k9.moe_matmul, k4.fused_mlp,
                k5.flash_attention)
    before = _counters(*wrappers)
    y = k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, (4, 128, K, N))
    assert torch.equal(y, k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros,
                                                     (4, 128, K, N)))
    k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, (4, 128, K, N), norm_w=nw)
    k9.moe_matmul(x, *e, (4, 128, K, N))
    k4.fused_mlp(x[:, None], nw, gu.data, gu.scales, gu.zeros, dn.data, dn.scales, dn.zeros,
                 (4, 128, K, 2 * F), (4, 128, F, K))
    from qtpu_torch.quant.pot import pot_codebook
    k7.codebook_matmul(x, qt.data, qt.scales, pot_codebook(4), (4, 128, K, N))
    q = torch.randn(1, 4, 40, 64).to(torch.bfloat16)
    kv = torch.randn(1, 2, 40, 64).to(torch.bfloat16)
    k5.flash_attention(q, kv, kv, 16)
    assert _counters(*wrappers) == before


# ------------------------------------------------------------------ K5

def _bshd_views(B, S, H, KV, hd, base=1 << 20, offset=0):
    """Pointers and strides of q, k, v as the eval path passes them:
    [B, H, S, hd] views of contiguous [B, S, H, hd] projections."""
    strides = []
    for heads in (H, KV, KV):
        strides += [S * heads * hd, hd, heads * hd]
    return (base + offset, base + (1 << 24), base + (1 << 25)), strides


@pytest.mark.parametrize("cfg", [TINYLLAMA_1_1B, MISTRAL_7B, GPT2_SMALL, OPT_125M,
                                 MIXTRAL_8X7B])
def test_the_eval_views_take_the_hopper_body(cfg):
    ptrs, strides = _bshd_views(1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert k5.flash_route(cfg.head_dim, ptrs, strides) == "wgmma"


@pytest.mark.parametrize("hd", [32, 48, 80, 96, 112])
def test_the_other_head_dims_take_the_hopper_body(hd):
    """The head dims K5 holds in the tile of the next multiple of 64 (hd 80:
    OPT-2.7B's eval views, 32 heads of 80) take its Hopper body too."""
    ptrs, strides = _bshd_views(1, 2048, 32, 32, hd)
    assert k5.supported(hd) and k5.flash_route(hd, ptrs, strides) == "wgmma"


def test_a_fused_qkv_split_takes_the_hopper_body():
    # q, k, v split from one [B, S, (H + 2 KV) hd] projection: rows of (H + 2 KV) hd
    B, S, H, KV, hd = 2, 300, 8, 2, 64
    row = (H + 2 * KV) * hd
    strides = [S * row, hd, row] * 3
    base = 1 << 20
    ptrs = (base, base + 2 * H * hd, base + 2 * (H + KV) * hd)
    assert k5.flash_route(hd, ptrs, strides) == "wgmma"


@pytest.mark.parametrize("offset,strides,why", [
    (4, None, "q 4-byte aligned"),
    (0, [2048 * 32 * 64, 64, 32 * 64 + 2] + [2048 * 4 * 64, 64, 4 * 64] * 2, "q rows of odd 4 bytes"),
    (0, [0, 64, 32 * 64] + [2048 * 4 * 64, 64, 4 * 64] * 2, "a broadcast batch"),
])
def test_q_the_hopper_body_does_not_take_keeps_the_mma_body(offset, strides, why):
    ptrs, s0 = _bshd_views(1, 2048, 32, 4, 64, offset=offset)
    assert k5.flash_route(64, ptrs, strides or s0) == "mma", why


@pytest.mark.parametrize("S,window", [(2048, 0), (2048, 256), (2048, 4096), (1000, 0),
                                      (1000, 300), (77, 0), (300, 100), (4096, 4096),
                                      (129, 1), (640, 128)])
def test_k5_visits_exactly_the_tiles_the_mask_keeps(S, window):
    bq = bk = k5.WGMMA_BQ
    mask = attention_mask(S, window, "cpu")
    for q0 in range(0, S, bq):
        rows = mask[q0:q0 + bq]
        want = [kt for kt in range(-(-S // bk)) if rows[:, kt * bk:(kt + 1) * bk].any()]
        assert list(flash_tiles(q0, S, window)) == want, (q0, want)
        for wg in (0, 1):  # tiles a warpgroup takes whole keep every (row, key)
            q0w = q0 + 64 * wg
            sub = mask[q0w:q0w + 64]
            if sub.numel() == 0:
                continue
            for kt in flash_tiles(q0, S, window):
                if not flash_tile_masked(kt * bk, q0w, window):
                    assert sub[:, kt * bk:(kt + 1) * bk].all(), (q0w, kt)
