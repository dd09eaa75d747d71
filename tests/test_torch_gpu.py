"""The port's CUDA kernels against their plain versions on the card.

Run on a machine with an NVIDIA Hopper GPU and nvcc:
    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu
(`--noconftest` where JAX is not installed: tests/conftest.py imports it).
Elsewhere every test here skips (decided in the `cuda` fixture, at run time).
Tolerances are those tests/test_pallas_kernels.py holds the TPU kernels to.
"""

import pytest
import torch

from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels import dequant_matmul as k1
from qtpu_torch.kernels import fused_mlp as k4
from qtpu_torch.kernels import kv_attention as k23

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / (torch.linalg.vector_norm(b) + 1e-6))


def _gen():
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("group", [32, 64, 128])  # W2 g32: the GEMV path at M > 8
@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("M", [1, 8, 77, 300])
def test_k1_matches_plain(cuda, bits, group, sym, M):
    g = _gen()
    K, N = 512, 384
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, bits, group, sym)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (bits, group, K, N)
    n0 = k1.quantized_matmul.launches
    got = k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta)
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta)
    torch.cuda.synchronize()
    assert k1.quantized_matmul.launches == n0 + 1
    assert _rel(got, want) < 2e-2


def test_k1_raises_on_what_it_does_not_take(cuda):
    qt = quantize_pack(torch.randn(256, 128, device=cuda), 4, 64)
    x = torch.randn(4, 512, device=cuda).to(torch.bfloat16)[:, ::2]  # not contiguous
    with pytest.raises(ValueError):
        k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, (4, 64, 256, 128))
    with pytest.raises(ValueError):
        k1.quantized_matmul(x.contiguous().float(), qt.data, qt.scales, qt.zeros,
                            (4, 64, 256, 128))


def _cache(g, L, B, KV, S, hd, dev):
    k = torch.randint(-127, 128, (L, B, KV, S, hd), generator=g, device=dev).to(torch.int8)
    v = torch.randint(-127, 128, (L, B, KV, S, hd), generator=g, device=dev).to(torch.int8)
    ks = torch.rand(L, B, KV, S, generator=g, device=dev) * 0.05 + 0.01
    vs = torch.rand(L, B, KV, S, generator=g, device=dev) * 0.05 + 0.01
    return k, v, ks, vs


def test_k2_matches_plain(cuda):
    g = _gen()
    L, B, KV, S, hd = 3, 4, 2, 40, 64
    cache = _cache(g, L, B, KV, S, hd, cuda)
    kn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([0, 17, S - 1, S], dtype=torch.int32, device=cuda)
    a = [t.clone() for t in cache]
    b = [t.clone() for t in cache]
    k23.cache_band_write(kn, vn, *a, pos, 1)
    k23.cache_band_write_plain(kn, vn, *b, pos, 1)
    torch.cuda.synchronize()
    for x, y in zip(a[:2], b[:2]):  # codes: equal up to one-code rounding ties
        d = (x.int() - y.int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= 2
    for x, y in zip(a[2:], b[2:]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("S", [40, 200])
@pytest.mark.parametrize("hd,KV,G", [(64, 4, 4), (128, 4, 4), (128, 1, 32)])
def test_k3_matches_plain(cuda, window, S, hd, KV, G):
    g = _gen()
    L, B = 2, 4
    H = KV * G
    cache = _cache(g, L, B, KV, S, hd, cuda)
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([0, 9, S // 2, S - 1], dtype=torch.int32, device=cuda)
    got = k23.decode_attention(q, *cache, pos, 1, window=window)
    want = k23.decode_attention_plain(q, *cache, pos, 1, window=window)
    want32 = k23.decode_attention_plain(q.float(), *cache, pos, 1, window=window)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2
    torch.testing.assert_close(got.float(), want32, rtol=2e-2, atol=2e-2)


def test_k3_raises_on_head_dim_over_128(cuda):
    g = _gen()
    cache = _cache(g, 1, 2, 1, 16, 256, cuda)
    q = torch.randn(2, 1, 256, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="<= 128"):
        k23.decode_attention(q, *cache, pos, 0)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 32])
def test_k4_matches_plain(cuda, bits, M):
    g = _gen()
    D, F, grp = 512, 1024, 128
    gu = quantize_pack(torch.randn(D, 2 * F, generator=g, device=cuda) * 0.05, bits, grp)
    dn = quantize_pack(torch.randn(F, D, generator=g, device=cuda) * 0.05, bits, grp)
    nw = (1.0 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(torch.bfloat16)
    x = torch.randn(M, 1, D, generator=g, device=cuda).to(torch.bfloat16)
    args = (x, nw, gu.data, gu.scales, gu.zeros, dn.data, dn.scales, dn.zeros,
            (bits, grp, D, 2 * F), (bits, grp, F, D))
    got, want = k4.fused_mlp(*args), k4.fused_mlp_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, want) < 3e-2
    assert _rel(got - x, want - x) < 3e-2


def test_decode_on_bf16_cache_raises(cuda):
    from qtpu_torch.models import TINY_TEST, llama
    from qtpu_torch.serve.kvcache import init_cache

    params = llama.init_params(TINY_TEST, device="cuda")
    cache = init_cache(TINY_TEST, 1, 16, device="cuda")
    ids = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="pallas_decode_attention_write_bf16"):
        llama.forward_with_cache(params, ids, ids, cache, TINY_TEST)


def _bf16_qkv(g, B, H, KV, S, hd, dev):
    q = (torch.randn(B, H, S, hd, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    k = (torch.randn(B, KV, S, hd, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("S", [1, 77, 256])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_k5_matches_plain(cuda, window, S, hd, G):
    from qtpu_torch.kernels import flash_attention as k5

    KV = 2
    q, k, v = _bf16_qkv(_gen(), 2, KV * G, KV, S, hd, cuda)
    n0 = k5.flash_attention.launches
    got = k5.flash_attention(q, k, v, window)
    want = k5.flash_attention_plain(q, k, v, window)
    want32 = k5.flash_attention_plain(q.float(), k.float(), v.float(), window)
    torch.cuda.synchronize()
    assert k5.flash_attention.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got, want) < 2e-2
    torch.testing.assert_close(got.float(), want32, rtol=2e-2, atol=2e-2)


def test_k5_on_the_views_causal_attention_passes(cuda):
    """[B, S, H, hd] projections split from one fused qkv output (v is a
    strided view) give what the CPU path gives."""
    from qtpu_torch.models.ops import causal_attention

    g = _gen()
    B, S, H, KV, hd = 2, 300, 8, 2, 64
    qkv = torch.randn(B, S, (H + 2 * KV) * hd, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = torch.split(qkv, [H * hd, KV * hd, KV * hd], dim=-1)
    q, k, v = (t.reshape(B, S, -1, hd) for t in (q, k, v))
    got = causal_attention(q.contiguous(), k.contiguous(), v, window=100)
    want = causal_attention(q.cpu(), k.cpu(), v.cpu(), window=100)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (B, S, H * hd)
    assert _rel(got.cpu(), want) < 2e-2


def test_k5_raises_on_what_it_does_not_take(cuda):
    from qtpu_torch.kernels import flash_attention as k5

    g = _gen()
    q, k, v = _bf16_qkv(g, 1, 6, 4, 32, 64, cuda)  # H % KV != 0
    with pytest.raises(ValueError, match="multiple"):
        k5.flash_attention(q, k, v)
    q, k, v = _bf16_qkv(g, 1, 4, 2, 32, 96, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k5.flash_attention(q, k, v)
    q, k, v = _bf16_qkv(g, 1, 4, 2, 32, 64, cuda)
    with pytest.raises(ValueError, match="bf16"):
        k5.flash_attention(q.float(), k, v)


def test_forward_on_card_matches_cpu(cuda):
    """The cacheless forward (K1 on packed fused sites, K5 with the sliding
    window binding at S = 100 > 8) against the same forward on the CPU."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINY_MISTRAL_TEST as cfg
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    params = llama.init_params(cfg, seed=3, device="cpu")
    params, qmeta = fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64}))
    ids = torch.randint(0, cfg.vocab_size, (2, 100), generator=torch.Generator().manual_seed(1))
    want = llama.forward(params, ids, cfg, qmeta)
    got = llama.forward(map_tree(params, lambda t: t.to(cuda)), ids.to(cuda), cfg, qmeta)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), want) < 3e-2
