"""Which body K9 (`moe_matmul`) and K6 (`w8a8_matmul`) launch on the card:
`moe_route` and `w8a8_route`, the plain-Python mirrors of the kernels' own
rules (csrc/moe_matmul.cu: moe_wgmma_fits, grouped; csrc/w8a8_matmul.cu:
w8a8_wgmma_fits). The wrappers count each launch by them, so these cases pin
the shapes of the MoE and W8A8 paths the port serves:

  K9 "wgmma"  K1's rule on the first expert's view (M > 8, group 64 or 128,
              N % 16 == 0, codes, scales and zeros 16-byte aligned) and every
              stride between two experts a multiple of 16 bytes
     "mma"    the other M > 8 calls whose groups hold 16k packed rows
     "gemv"   M <= 8 (the split-K GEMV over all experts), W2 g32
  K6 "wgmma"  M > 8, N % 16 == 0, weight and scales 16-byte aligned
     "mma"    the other M > 8 calls
     "gemv"   M <= 8

The kernels run only on the card (tests/test_torch_gpu.py holds the counters
to the kernel the profiler saw); here a CPU tensor takes the plain version
and counts no route.
"""

import pytest
import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import int8_matmul as k6
from qtpu_torch.kernels import moe_matmul as k9
from qtpu_torch.models.config import MIXTRAL_8X7B, TINYLLAMA_1_1B

ALIGNED = (1 << 20, 1 << 21, 1 << 22)  # 16-byte aligned codes, scales, zeros

_X = MIXTRAL_8X7B
# K9's sites: (E, K, N) of Mixtral-8x7B's expert gate/up (x shared by the
# experts) and down (x per expert), and one Qwen2-57B-A14B expert site
K9_SITES = {"mixtral_gate_up": (_X.num_experts, _X.hidden_size, _X.intermediate_size),
            "mixtral_down": (_X.num_experts, _X.intermediate_size, _X.hidden_size),
            "qwen2_57b_gate_up": (64, 3584, 2560)}
_T = TINYLLAMA_1_1B
# K6's sites: (K, N) of TinyLlama-1.1B's W8A8 linears (q/o, k/v, gate/up,
# down, lm_head)
K6_SITES = {"q_o": (_T.hidden_size, _T.q_dim), "k_v": (_T.hidden_size, _T.kv_dim),
            "gate_up": (_T.hidden_size, _T.intermediate_size),
            "down": (_T.intermediate_size, _T.hidden_size),
            "lm_head": (_T.hidden_size, _T.vocab_size)}


def test_sites_are_the_ones_the_routes_were_built_for():
    assert K9_SITES == {"mixtral_gate_up": (8, 4096, 14336), "mixtral_down": (8, 14336, 4096),
                        "qwen2_57b_gate_up": (64, 3584, 2560)}
    assert K6_SITES == {"q_o": (2048, 2048), "k_v": (2048, 256), "gate_up": (2048, 5632),
                        "down": (5632, 2048), "lm_head": (2048, 32000)}


@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("M,route", [(8, "gemv"), (1024, "wgmma")])  # decode, serve prefill
@pytest.mark.parametrize("site", sorted(K9_SITES))
def test_k9_sites_at_decode_and_prefill(site, M, route, per_expert):
    _, K, N = K9_SITES[site]
    assert k9.moe_route(M, K, N, 4, 128, ALIGNED, per_expert) == route


@pytest.mark.parametrize("M", [9, 77, 256, 1000])  # ragged M: rows past M masked per expert
def test_k9_ragged_m_takes_wgmma(M):
    assert k9.moe_route(M, 512, 384, 4, 128, ALIGNED, per_expert_input=True) == "wgmma"


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("which", [0, 1, 2])  # the expert leaf's codes, scales, zeros
def test_k9_unaligned_expert_leaf_keeps_mma(offset, which):
    ptrs = list(ALIGNED)
    ptrs[which] += offset
    assert k9.moe_route(1024, 4096, 14336, 4, 128, ptrs) == "mma"


@pytest.mark.parametrize("bits,route", [(2, "gemv"), (4, "mma"), (8, "mma")])
def test_k9_group_32_keeps_the_earlier_bodies(bits, route):
    # 8 / 16 / 32 packed rows a group: no whole wgmma stage
    assert k9.moe_route(1024, 4096, 14336, bits, 32, ALIGNED) == route


def test_k9_n_not_a_multiple_of_16_keeps_mma():
    assert k9.moe_route(1024, 512, 388, 4, 128, ALIGNED) == "mma"


def test_k9_stacked_layer_views_take_wgmma():
    """The MoE model's expert leaves are [L, E, ...] stacks; layer l's view
    W[l] starts E Kp N, E (K / g) N * 2 and E (K / g) N bytes in: multiples
    of 16 when N % 16 == 0, so every layer's experts take the route."""
    g = torch.Generator().manual_seed(0)
    E, K, N = 2, 256, 48
    parts = [quantize_pack(torch.randn(K, N, generator=g) * 0.02, 4, 128) for _ in range(2 * E)]
    stacked = [torch.stack([getattr(p, f) for p in parts]).reshape(2, E, *getattr(parts[0], f).shape)
               for f in ("data", "scales", "zeros")]
    for layer in (0, 1):
        ptrs = [t[layer].data_ptr() for t in stacked]
        assert all(p % 16 == 0 for p in ptrs)
        assert k9.moe_route(64, K, N, 4, 128, ptrs, per_expert_input=True) == "wgmma"


@pytest.mark.parametrize("M,route", [(8, "gemv"), (1024, "wgmma"), (2048, "wgmma")])
@pytest.mark.parametrize("site", sorted(K6_SITES))
def test_k6_sites_at_decode_prefill_and_eval(site, M, route):
    _, N = K6_SITES[site]
    assert k6.w8a8_route(M, N, ALIGNED[:2]) == route


@pytest.mark.parametrize("N", [388, 2052, 132])  # N % 4 == 0, N % 16 != 0
def test_k6_n_not_a_multiple_of_16_keeps_mma(N):
    assert k6.w8a8_route(1024, N, ALIGNED[:2]) == "mma"
    assert k6.w8a8_route(8, N, ALIGNED[:2]) == "gemv"


@pytest.mark.parametrize("which", [0, 1])  # weight, scales
def test_k6_unaligned_weight_keeps_mma(which):
    ptrs = list(ALIGNED[:2])
    ptrs[which] += 4
    assert k6.w8a8_route(1024, 2048, ptrs) == "mma"


def test_cpu_tensors_take_the_plain_version_and_count_no_route():
    g = torch.Generator().manual_seed(0)
    E, K, N, M = 2, 256, 64, 16
    parts = [quantize_pack(torch.randn(K, N, generator=g) * 0.02, 4, 128) for _ in range(E)]
    data, scales, zeros = (torch.stack([getattr(p, f) for p in parts])
                           for f in ("data", "scales", "zeros"))
    x = torch.randn(E, M, K, generator=g).to(torch.bfloat16)
    w8 = quantize_pack(torch.randn(K, N, generator=g) * 0.02, 8, K)

    def counters():
        return (k9.moe_matmul.launches, k9.moe_matmul.wgmma_launches,
                k9.moe_matmul.mma_launches, k9.moe_matmul_mma.launches,
                k6.w8a8_matmul.launches, k6.w8a8_matmul.wgmma_launches,
                k6.w8a8_matmul.mma_launches, k6.w8a8_matmul_mma.launches)

    before = counters()
    meta = (4, 128, K, N)
    y9 = k9.moe_matmul(x, data, scales, zeros, meta, per_expert_input=True)
    torch.testing.assert_close(
        y9, k9.moe_matmul_plain(x, data, scales, zeros, meta, per_expert_input=True))
    m6 = (8, K, K, N)
    y6 = k6.w8a8_matmul(x[0], w8.data, w8.scales, w8.zeros, m6)
    torch.testing.assert_close(y6, k6.w8a8_matmul_plain(x[0], w8.data, w8.scales, w8.zeros, m6))
    assert counters() == before


def test_the_mma_entries_take_card_tensors_only():
    """The earlier bodies' entries exist for comparisons on the card and have
    no CPU version."""
    g = torch.Generator().manual_seed(0)
    K, N = 256, 64
    qt = quantize_pack(torch.randn(K, N, generator=g) * 0.02, 4, 128)
    w8 = quantize_pack(torch.randn(K, N, generator=g) * 0.02, 8, K)
    x = torch.randn(16, K, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        k9.moe_matmul_mma(x, qt.data[None], qt.scales[None], qt.zeros[None], (4, 128, K, N))
    with pytest.raises(ValueError, match="card only"):
        k6.w8a8_matmul_mma(x, w8.data, w8.scales, w8.zeros, (8, K, K, N))
