"""Which body K1 (`quantized_matmul`) and K7 (`codebook_matmul`) launch on
the card: `dq_route` and `cb_route`, the plain-Python mirror of the kernels'
own rule (csrc/dq_wgmma.cuh: wgmma_fits; csrc/dequant_matmul.cu and
codebook_matmul.cu: dq_dispatch, cb_dispatch). The wrappers count each
launch by it, so these cases pin the shapes of every path the port serves:

  "wgmma"  M > 8, group 64 or 128, N % 16 == 0 (TMA and the bulk copies
           stride the N-wide rows), codes, scales and zeros 16-byte aligned
  "mma"    the other M > 8 calls whose groups hold a multiple of 16 packed
           rows (the mma.sync body): ragged N, N % 16 != 0, other groups,
           an unaligned code, scale or zero tensor
  "gemv"   M <= 8, and groups of fewer packed rows (W2 g32)

The kernels themselves run only on the card (tests/test_torch_gpu.py holds
the counters to the kernel the profiler saw); here a CPU tensor takes the
plain version and counts no route.
"""

import pytest
import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import codebook_matmul as k7
from qtpu_torch.kernels import dequant_matmul as k1
from qtpu_torch.models.config import GPT2_SMALL, OPT_125M, TINYLLAMA_1_1B

ALIGNED = (1 << 20, 1 << 21, 1 << 22)  # 16-byte aligned codes, scales, zeros

_T = TINYLLAMA_1_1B
# (K, N) of TinyLlama-1.1B's fused W4 g128 sites
TINYLLAMA_SITES = {"qkv": (_T.hidden_size, _T.q_dim + 2 * _T.kv_dim),
                   "o": (_T.q_dim, _T.hidden_size),
                   "gateup": (_T.hidden_size, 2 * _T.intermediate_size),
                   "down": (_T.intermediate_size, _T.hidden_size),
                   "lm_head": (_T.hidden_size, _T.vocab_size)}


def test_tinyllama_sites_are_the_ones_the_route_was_built_for():
    assert TINYLLAMA_SITES == {"qkv": (2048, 2560), "o": (2048, 2048), "gateup": (2048, 11264),
                               "down": (5632, 2048), "lm_head": (2048, 32000)}


@pytest.mark.parametrize("M", [1024, 2048])  # serve prefill (8 x 128), eval block
@pytest.mark.parametrize("site", sorted(TINYLLAMA_SITES))
def test_tinyllama_prefill_and_eval_sites_take_wgmma(site, M):
    _, N = TINYLLAMA_SITES[site]
    assert k1.dq_route(M, N, 4, 128, ALIGNED) == "wgmma"
    assert k7.cb_route(M, N, 128, ALIGNED) == "wgmma"


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("site", sorted(TINYLLAMA_SITES))
def test_decode_rows_keep_the_gemv(site, M):
    _, N = TINYLLAMA_SITES[site]
    assert k1.dq_route(M, N, 4, 128, ALIGNED) == "gemv"
    assert k7.cb_route(M, N, 128, ALIGNED) == "gemv"


@pytest.mark.parametrize("M", [9, 77, 1000])  # ragged M: TMA zero-fills the box past M
def test_ragged_m_takes_wgmma(M):
    assert k1.dq_route(M, 2560, 4, 128, ALIGNED) == "wgmma"
    assert k7.cb_route(M, 2560, 64, ALIGNED) == "wgmma"


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("group", [64, 128])
def test_w2_w4_w8_at_g64_g128_take_wgmma(bits, group):
    assert k1.dq_route(300, 384, bits, group, ALIGNED) == "wgmma"


@pytest.mark.parametrize("bits,group,route", [
    (2, 32, "gemv"),   # 8 packed rows a group: fewer than one mma.sync stage
    (4, 32, "mma"),    # 16 packed rows: the mma.sync body, not a whole wgmma stage
    (8, 32, "mma"),
    (4, 256, "mma"),   # a group of 256 spans two 128-wide stages
    (2, 256, "mma"),
])
def test_other_groups_keep_the_earlier_bodies(bits, group, route):
    assert k1.dq_route(300, 384, bits, group, ALIGNED) == route


@pytest.mark.parametrize("M,route", [(8, "gemv"), (1024, "mma")])
def test_gpt2_ragged_lm_head_keeps_the_earlier_bodies(M, route):
    # [768, 50257]: N % 16 != 0, so TMA cannot stride the packed rows
    N = GPT2_SMALL.vocab_size
    assert N % 16 != 0
    assert k1.dq_route(M, N, 4, 128, ALIGNED) == route


@pytest.mark.parametrize("N", [2052, 2056, 388])  # N % 4 == 0 or 8 == 0, N % 16 != 0
def test_n_not_a_multiple_of_16_keeps_mma(N):
    assert k1.dq_route(1024, N, 4, 128, ALIGNED) == "mma"
    assert k7.cb_route(1024, N, 128, ALIGNED) == "mma"


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("which", [0, 1, 2])  # codes, scales, zeros
def test_unaligned_weight_keeps_mma(offset, which):
    ptrs = list(ALIGNED)
    ptrs[which] += offset
    assert k1.dq_route(1024, 2560, 4, 128, ptrs) == "mma"
    assert k7.cb_route(1024, 2560, 128, ptrs[:2]) == ("mma" if which < 2 else "wgmma")


def test_opt_fused_qkv_and_lm_head_take_wgmma_on_their_layer_views():
    D, V = OPT_125M.hidden_size, OPT_125M.vocab_size
    assert (D, V) == (768, 50272) and V % 16 == 0
    g = torch.Generator().manual_seed(0)
    for N in (3 * D, V):
        qt = quantize_pack(torch.randn(D, N, generator=g) * 0.02, 4, 128)
        # [L, ...] stacks: layer 1's views start Kp * N, (K / g) * N * 2 and
        # (K / g) * N bytes in, multiples of 16 when N % 16 == 0
        stacked = [torch.stack([t, t]) for t in (qt.data, qt.scales, qt.zeros)]
        for layer in (0, 1):
            ptrs = [t[layer].data_ptr() for t in stacked]
            assert all(p % 16 == 0 for p in ptrs)
            assert k1.dq_route(1024, N, 4, 128, ptrs) == "wgmma"


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    g = torch.Generator().manual_seed(0)
    K, N, M = 256, 128, 32
    qt = quantize_pack(torch.randn(K, N, generator=g) * 0.02, 4, 128)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    before = (k1.quantized_matmul.launches, k1.quantized_matmul.wgmma_launches,
              k1.quantized_matmul.mma_launches, k7.codebook_matmul.wgmma_launches,
              k7.codebook_matmul.mma_launches)
    y = k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, (4, 128, K, N))
    torch.testing.assert_close(
        y, k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, (4, 128, K, N)))
    cb = torch.linspace(-1, 1, 16)
    y7 = k7.codebook_matmul(x, qt.data, qt.scales, cb, (4, 128, K, N))
    torch.testing.assert_close(
        y7, k7.codebook_matmul_plain(x, qt.data, qt.scales, cb, (4, 128, K, N)))
    after = (k1.quantized_matmul.launches, k1.quantized_matmul.wgmma_launches,
             k1.quantized_matmul.mma_launches, k7.codebook_matmul.wgmma_launches,
             k7.codebook_matmul.mma_launches)
    assert after == before


def test_count_route_adds_one_to_the_routes_counter():
    class W:
        wgmma_launches = 0
        mma_launches = 0

    for route in ("wgmma", "mma", "gemv", "wgmma"):
        k1.count_route(W, route)
    assert (W.wgmma_launches, W.mma_launches) == (2, 1)
