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
from qtpu_torch.kernels import moe_matmul as k9

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


# (K, N) of TinyLlama-1.1B's fused W4 g128 sites: the Hopper route's shapes
# at serve prefill (M 1024) and eval (M 2048)
TINYLLAMA_SITES = {"qkv": (2048, 2560), "o": (2048, 2048), "gateup": (2048, 11264),
                   "down": (5632, 2048), "lm_head": (2048, 32000)}
K1_CASES = (
    # (bits, group, sym, M, K, N): W2/W4/W8 at every group, GEMV rows, ragged M
    # (W2 g32: the GEMV path at M > 8; g64/g128 at M > 8: the Hopper route)
    [(b, g, s, m, 512, 384) for b in (2, 4, 8) for g in (32, 64, 128) for s in (False, True)
     for m in (1, 8, 77, 300)]
    + [(4, 128, False, m, k, n) for k, n in TINYLLAMA_SITES.values() for m in (1024, 2048)]
    + [(4, 128, False, m, 2048, 2560) for m in (77, 1000)]
    + [(b, g, s, 1024, 2048, 2560) for b in (2, 8) for g in (64, 128) for s in (False, True)]
)


def _route_and_out(wrapper, call):
    """call()'s output and the body the wrapper's route counters saw
    ("gemv_tc": the tensor-core GEMV, for the wrappers that count it)."""
    w0, m0 = wrapper.wgmma_launches, wrapper.mma_launches
    t0 = getattr(wrapper, "gemv_tc_launches", 0)
    out = call()
    torch.cuda.synchronize()
    if wrapper.wgmma_launches > w0:
        return out, "wgmma"
    if getattr(wrapper, "gemv_tc_launches", 0) > t0:
        return out, "gemv_tc"
    return out, "mma" if wrapper.mma_launches > m0 else "gemv"


def _rule(route, M, K, N, bits, group, ptrs):
    """K1's rule (dq_route), refined at M <= 8 by gemv_route."""
    return k1.gemv_route(M, K, N, bits, group, ptrs) if route == "gemv" else route


def _graph_kernels(call, reps=1) -> dict:
    """{kernel name (demangled): launches} of `reps` calls of call(), read
    from the kernel nodes of a CUDA graph captured over them
    (qtpu_torch.serve.graphs.kernel_nodes). The profiler's kernel records
    arrive from CUPTI's activity buffers after the session, and late in a
    long run of this file a session came back without some of them while
    the launches happened; a captured graph holds one node per launch,
    whatever the profiler delivers. call() runs once eagerly first (its
    libraries loaded, its attributes set) and must not sync."""
    from qtpu_torch.serve.graphs import kernel_nodes

    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    torch.cuda.synchronize()
    seen = {}
    for name in kernel_nodes(g):
        seen[name] = seen.get(name, 0) + 1
    return seen


def _profiled_route(wrapper, call, reps=4):
    """The route the wrapper's counters saw over `reps` calls of call() (the
    same one each time, else "mixed") and the names of the kernels those
    calls launched (the nodes of a CUDA graph captured over them,
    _graph_kernels; the warm-up call is not counted)."""
    call()
    torch.cuda.synchronize()
    w0, m0 = wrapper.wgmma_launches, wrapper.mma_launches
    t0 = getattr(wrapper, "gemv_tc_launches", 0)
    names = _graph_kernels(call, reps)
    w1, m1, t1 = wrapper.wgmma_launches, wrapper.mma_launches, getattr(wrapper, "gemv_tc_launches", 0)
    dw, dm, dt = w1 - w0, m1 - m0, t1 - t0
    n = reps + 1  # the helper's own warm-up call counts too
    seen = {(n, 0, 0): "wgmma", (0, n, 0): "mma", (0, 0, n): "gemv_tc",
            (0, 0, 0): "gemv"}.get((dw, dm, dt), "mixed")
    return seen, list(names)


def _same_bits(a, b):
    return bool((a.view(torch.int16) == b.view(torch.int16)).all())


@pytest.mark.parametrize("bits,group,sym,M,K,N", K1_CASES)
def test_k1_matches_plain(cuda, bits, group, sym, M, K, N):
    g = _gen()
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, bits, group, sym)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (bits, group, K, N)
    n0 = k1.quantized_matmul.launches
    got, route = _route_and_out(
        k1.quantized_matmul, lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta))
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta)
    torch.cuda.synchronize()
    assert k1.quantized_matmul.launches == n0 + 1
    assert _rel(got, want) < 2e-2
    ptrs = [t.data_ptr() for t in (qt.data, qt.scales, qt.zeros) if t is not None]
    assert route == _rule(k1.dq_route(M, N, bits, group, ptrs), M, K, N, bits, group, ptrs)
    if M > 8 or route == "gemv_tc":  # the tensor-core routes give the same bits call after call
        assert _same_bits(got, k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta))


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


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_k2_launches_match_plain_and_the_earlier_kernel(cuda, hd):
    """The kernel with and without programmatic dependent launch writes
    what the plain write does (test_k2_matches_plain's tolerances) and the
    earlier kernel's bits exactly; an inactive slot (pos = S) and a negative
    pos write nothing."""
    g = _gen()
    L, B, KV, S = 2, 8, 4, 48
    cache = _cache(g, L, B, KV, S, hd, cuda)
    kn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    vn = (torch.randn(B, 1, KV, hd, generator=g, device=cuda) * 3).to(torch.bfloat16)
    pos = torch.tensor([0, 5, 17, 31, S - 1, S, -1, 24], dtype=torch.int32, device=cuda)
    plain = [t.clone() for t in cache]
    k23.cache_band_write_plain(kn, vn, *plain, pos, 0)
    writes = {}
    for fn in (k23.cache_band_write, k23.cache_band_write_serial, k23.cache_band_write_simt):
        got = [t.clone() for t in cache]
        n0 = fn.launches
        fn(kn, vn, *got, pos, 0)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        for x, y in zip(got[:2], plain[:2]):
            d = (x.int() - y.int()).abs()
            assert int(d.max()) <= 1 and int((d > 0).sum()) <= 2
        for x, y in zip(got[2:], plain[2:]):
            torch.testing.assert_close(x, y, rtol=1e-6, atol=0)
        writes[fn.__name__] = got
    for name in ("cache_band_write", "cache_band_write_serial"):
        assert all(bool((a == b).all()) for a, b in zip(writes[name],
                                                        writes["cache_band_write_simt"]))


def test_k2_raises_on_what_it_does_not_take(cuda):
    g = _gen()
    cache = _cache(g, 1, 2, 2, 16, 36, cuda)  # hd 36: not whole 16-byte chunks
    kn = torch.randn(2, 1, 2, 36, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        k23.cache_band_write(kn, kn, *cache, pos, 0)
    k23.cache_band_write_simt(kn, kn, *cache, pos, 0)  # the earlier kernel takes any hd


# (hd, KV, G) of the decode attention cases: G in {1, 8, 32} at hd 64 and 128,
# the other head dims the kernels took first (32 to 128 in steps of 16;
# OPT-2.7B is MHA at 80), and their whole domain's edges: hd 40 and 136 (hd %
# 16 == 8), hd 256 (Falcon3-7B's decode: KV 4, G 3) and G 48 (one block of
# three m-tiles) and G 48 at hd 256 (two head groups)
DECODE_HEADS = [(64, 4, 4), (128, 4, 4), (128, 1, 32), (64, 2, 1), (128, 8, 1), (64, 4, 8),
                (128, 2, 8), (64, 1, 32), (32, 4, 4), (48, 2, 4), (80, 8, 1), (80, 4, 8),
                (80, 1, 32), (96, 8, 4), (112, 2, 1), (40, 2, 4), (136, 2, 4), (256, 4, 3),
                (64, 1, 48), (256, 1, 48)]
# S of 2 and 3 64-row chunks beside the ragged ones
DECODE_S = [40, 128, 192, 200]


def _boundary_pos(S, last):
    """pos of 8 sequences: the first rows, pos on a 64-row chunk (and
    slice) boundary and one row past it (where S reaches them), S - 1, and
    `last` (S or more: an inactive slot)."""
    return [0, 9, S // 2, *(min(p, S - 1) for p in (63, 64, 65)), S - 1, last]


@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", DECODE_S)
@pytest.mark.parametrize("hd,KV,G", DECODE_HEADS)
def test_k3_matches_plain(cuda, window, S, hd, KV, G):
    g = _gen()
    L, B = 2, 8
    H = KV * G
    cache = _cache(g, L, B, KV, S, hd, cuda)
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor(_boundary_pos(S, S), dtype=torch.int32, device=cuda)  # last: inactive
    got = k23.decode_attention(q, *cache, pos, 1, window=window)
    want = k23.decode_attention_plain(q, *cache, pos, 1, window=window)
    want32 = k23.decode_attention_plain(q.float(), *cache, pos, 1, window=window)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2
    torch.testing.assert_close(got.float(), want32, rtol=2e-2, atol=2e-2)


def test_k3_raises_on_head_dim_over_128(cuda):
    """hd 256 is in the kernel's domain now (its tests above); past 256 it
    raises, and so does the earlier body past 128."""
    g = _gen()
    cache = _cache(g, 1, 2, 1, 16, 264, cuda)
    q = torch.randn(2, 1, 264, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="<= 256"):
        k23.decode_attention(q, *cache, pos, 0)
    cache = _cache(g, 1, 2, 1, 16, 256, cuda)
    q = torch.randn(2, 1, 256, generator=g, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="earlier body"):
        k23.decode_attention_simt(q, *cache, pos, 0)


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


def _pot_site(g, K, N, group, dev, apot=False):
    """A [K, N] weight packed as a POT (or APOT) codebook site."""
    from qtpu_torch.core.packing import pack_int4
    from qtpu_torch.quant import apot, pot

    w = torch.randn(K, N, generator=g, device=dev) * 0.02
    grid = (0.01, 2.01, 0.25)
    if apot:
        codes, sc, cb = apot.apot_quantize_codes(w, 4, group, grid=grid)
    else:
        codes, sc = pot.pot_quantize_codes(w, 4, group, grid=grid)
        cb = pot.pot_codebook(4, device=dev)
    return pack_int4(codes, group), sc.to(torch.bfloat16), cb


K7_CASES = (
    # (group, M, apot, K, N)
    [(g, m, a, 512, 384) for g in (32, 64, 128) for m in (1, 8, 77, 300) for a in (False, True)]
    + [(128, m, a, k, n) for k, n in TINYLLAMA_SITES.values() for m in (1024, 2048)
       for a in (False, True)]
    + [(g, m, a, 2048, 2560) for g in (64, 128) for m in (77, 1000) for a in (False, True)]
)


@pytest.mark.parametrize("group,M,apot,K,N", K7_CASES)
def test_k7_matches_plain(cuda, group, M, apot, K, N):
    from qtpu_torch.kernels import codebook_matmul as k7

    g = _gen()
    data, sc, cb = _pot_site(g, K, N, group, cuda, apot)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (4, group, K, N)
    n0 = k7.codebook_matmul.launches
    got, route = _route_and_out(k7.codebook_matmul,
                                lambda: k7.codebook_matmul(x, data, sc, cb, meta))
    want = k7.codebook_matmul_plain(x, data, sc, cb, meta)
    torch.cuda.synchronize()
    assert k7.codebook_matmul.launches == n0 + 1
    # the Pallas kernel's test: relative Frobenius < 2e-2, atol 5% of max
    assert _rel(got, want) < 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=0.05 * float(want.float().abs().max()))
    ptrs = (data.data_ptr(), sc.data_ptr())
    assert route == _rule(k7.cb_route(M, N, group, ptrs), M, K, N, 4, group, ptrs)
    if M > 8 or route == "gemv_tc":
        assert _same_bits(got, k7.codebook_matmul(x, data, sc, cb, meta))


def test_hopper_route_replays_in_a_cuda_graph(cuda):
    """K1 and K7 on the Hopper route captured in a CUDA graph (the tensor
    maps are encoded at capture and live in the launch's parameters) give
    the eager call's bits on replay."""
    from qtpu_torch.kernels import codebook_matmul as k7

    g = _gen()
    K, N, M = 2048, 2560, 300
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, 4, 128)
    data, sc, cb = _pot_site(g, K, N, 128, cuda)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    m1, m7 = (4, 128, K, N), (4, 128, K, N)
    eager = (k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, m1),
             k7.codebook_matmul(x, data, sc, cb, m7))
    w1, w7 = k1.quantized_matmul.wgmma_launches, k7.codebook_matmul.wgmma_launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm on a side stream before capture
        k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, m1)
        k7.codebook_matmul(x, data, sc, cb, m7)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y1 = k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, m1)
        y7 = k7.codebook_matmul(x, data, sc, cb, m7)
    y1.zero_()
    y7.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert k1.quantized_matmul.wgmma_launches == w1 + 2
    assert k7.codebook_matmul.wgmma_launches == w7 + 2
    assert _same_bits(y1, eager[0]) and _same_bits(y7, eager[1])


@pytest.mark.parametrize("M,N,group,route", [
    (300, 384, 128, "wgmma"), (300, 384, 64, "wgmma"),  # the Hopper route
    (300, 388, 128, "mma"),    # N % 16 != 0: the mma.sync body
    (300, 384, 256, "mma"),    # a group of 256: the mma.sync body
    (8, 384, 128, "gemv_tc"),  # decode rows: the tensor-core GEMV
    (8, 388, 128, "gemv"),     # decode rows it does not take (N % 16 != 0): dq_core
])
def test_route_counters_name_the_kernel_that_ran(cuda, M, N, group, route):
    """The wrapper's route counters agree with the kernel its calls launched."""
    g = _gen()
    K = 512
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, 4, group)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (4, group, K, N)
    k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta)  # built and warm
    torch.cuda.synchronize()
    seen, keys = _profiled_route(
        k1.quantized_matmul, lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta))
    names = [k for k in keys if "dq_" in k]
    kernel = {"wgmma": "dq_wgmma_kernel", "mma": "dq_mma_kernel", "gemv": "dq_kernel",
              "gemv_tc": "dq_gemv_tc_kernel"}[route]
    assert seen == route
    assert names and all(kernel in n for n in names if "dq_finish" not in n), keys


@pytest.mark.parametrize("M,N,route", [
    (300, 384, "wgmma"),  # the Hopper route
    (300, 388, "mma"),    # N % 16 != 0: the mma.sync body
    (8, 384, "gemv"),     # decode rows (K9 and K6: the tensor-core GEMV)
    (8, 388, "gemv"),     # decode rows the tensor-core GEMV does not take
])
def test_k9_k6_route_counters_name_the_kernel_that_ran(cuda, M, N, route):
    """The route counters of K9 and K6 agree with the kernel their calls launched."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    K = 512
    data, scales, zeros = _experts(g, 2, K, N, 4, 128, cuda)
    d8, s8, z8, m8 = _w8_site(g, K, N, cuda)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (4, 128, K, N)
    calls = {"K9": (k9.moe_matmul, lambda: k9.moe_matmul(x, data, scales, zeros, meta)),
             "K6": (k6.w8a8_matmul, lambda: k6.w8a8_matmul(x, d8, s8, z8, m8))}
    kernels = {"K9": {"wgmma": "dq_wgmma_kernel", "mma": "moe_mma_kernel",
                      "gemv": "moe_gemv_kernel", "gemv_tc": "dq_gemv_tc_kernel"},
               "K6": {"wgmma": "w8a8_wgmma_kernel", "mma": "w8a8_mma_kernel",
                      "gemv": "w8a8_gemv_kernel", "gemv_tc": "w8a8_gemv_tc_kernel"}}
    for name, (wrapper, call) in calls.items():
        call()  # built and warm
        torch.cuda.synchronize()
        seen, keys = _profiled_route(wrapper, call)
        want = "gemv_tc" if route == "gemv" and N % 16 == 0 else route
        names = [k for k in keys if any(n in k for n in kernels[name].values())]
        assert seen == want, name
        assert names and all(kernels[name][want] in n for n in names), (name, keys)


def test_k7_raises_on_what_it_does_not_take(cuda):
    from qtpu_torch.kernels import codebook_matmul as k7

    data, sc, cb = _pot_site(_gen(), 256, 128, 64, cuda)
    x = torch.randn(4, 256, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="4-bit"):
        k7.codebook_matmul(x, data, sc, cb, (8, 64, 256, 128))
    with pytest.raises(ValueError, match="codebook"):
        k7.codebook_matmul(x, data, sc, torch.zeros(32, device=cuda), (4, 64, 256, 128))
    with pytest.raises(ValueError, match="bf16"):
        k7.codebook_matmul(x.float(), data, sc, cb, (4, 64, 256, 128))


@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", DECODE_S)
@pytest.mark.parametrize("hd,KV,G", DECODE_HEADS)
def test_k8_matches_plain(cuda, window, S, hd, KV, G):
    g = _gen()
    L, B = 2, 8
    H = KV * G
    k = (torch.randn(L, B, KV, S, hd, generator=g, device=cuda)).to(torch.bfloat16)
    v = (torch.randn(L, B, KV, S, hd, generator=g, device=cuda)).to(torch.bfloat16)
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor(_boundary_pos(S, S), dtype=torch.int32, device=cuda)  # last: inactive
    kc, vc, kp, vp = k.clone(), v.clone(), k.clone(), v.clone()
    n0 = k23.decode_attention_write_bf16.launches
    got = k23.decode_attention_write_bf16(q, kn, vn, kc, vc, pos, 1, window=window)
    want = k23.decode_attention_write_bf16_plain(q, kn, vn, kp, vp, pos, 1, window=window)
    torch.cuda.synchronize()
    assert k23.decode_attention_write_bf16.launches == n0 + 1
    assert torch.equal(kc, kp) and torch.equal(vc, vp)  # the write, exactly
    torch.testing.assert_close(got[:-1].float(), want[:-1].float(), rtol=3e-2, atol=3e-2)
    assert bool(torch.isfinite(got.float()).all())


def test_decode_on_bf16_cache_raises(cuda):
    """A decode step on a bf16 cache runs K8 (once per layer) and agrees
    with the CPU's plain versions, teacher-forced over 3 steps."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.kernels import codebook_matmul as k7
    from qtpu_torch.models import TINY_TEST, llama
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    params = llama.init_params(TINY_TEST, device="cpu")
    params, qmeta = fuse_packed_sites(*pack_model(params, "pot", {"w_bit": 4, "q_group_size": 64,
                                                                  "grid_step": 0.25}))
    ids = torch.randint(0, TINY_TEST.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = map_tree(params, lambda t: t.to(dev))
        cache = init_cache(TINY_TEST, 2, 24, device=dev)
        logits, cache = prefill(p, ids.to(dev), cache, TINY_TEST, qmeta)
        res, pos = [logits.float().cpu()], torch.full((2,), 12, dtype=torch.int32, device=dev)
        n0 = (k23.decode_attention_write_bf16.launches, k7.codebook_matmul.launches)
        for i in range(3):
            tok = ids[:, i].to(torch.int32).to(dev)
            logits, cache = decode_step(p, tok, pos, cache, TINY_TEST, qmeta)
            res.append(logits.float().cpu())
            pos = pos + 1
        if dev == "cuda":
            L = TINY_TEST.num_layers
            assert k23.decode_attention_write_bf16.launches - n0[0] == 3 * L
            assert k7.codebook_matmul.launches - n0[1] == 3 * (4 * L + 1)
        outs[dev] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) < 3e-2


def _bf16_qkv(g, B, H, KV, S, hd, dev):
    q = (torch.randn(B, H, S, hd, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    k = (torch.randn(B, KV, S, hd, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    v = torch.randn(B, KV, S, hd, generator=g, device=dev).to(torch.bfloat16)
    return q, k, v


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("S", [1, 77, 256])
@pytest.mark.parametrize("hd", [64, 128, 32, 48, 80, 96, 112, 8, 40, 136, 256])
@pytest.mark.parametrize("G", [1, 4, 8, 24])
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


@pytest.mark.parametrize("H,KV,hd", [(8, 2, 64), (7, 1, 64), (4, 1, 128), (3, 1, 128)])
def test_k5_on_the_views_causal_attention_passes(cuda, H, KV, hd):
    """[B, S, H, hd] projections split from one fused qkv output (v is a
    strided view) give what the CPU path gives; one KV head too (a TP rank
    of Qwen2-0.5B at tp 2, of Qwen2-7B at tp 8), whose k and v views differ
    in their head stride alone."""
    from qtpu_torch.models.ops import causal_attention

    g = _gen()
    B, S = 2, 300
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
    q, k, v = _bf16_qkv(g, 1, 4, 2, 32, 36, cuda)  # not a multiple of 8
    with pytest.raises(ValueError, match="head_dim"):
        k5.flash_attention(q, k, v)
    q, k, v = _bf16_qkv(g, 1, 4, 2, 32, 264, cuda)  # past 256
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


def _w8_site(g, K, N, dev):
    """A per-channel asymmetric W8 site (one group spanning K)."""
    qt = quantize_pack(torch.randn(K, N, generator=g, device=dev) * 0.05, 8, K)
    return qt.data, qt.scales, qt.zeros, (8, K, K, N)


def _k6_err(got, want):
    """The Pallas kernel's test metric: max |err| / max |ref|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


# decode (M <= 8, the split-K GEMV), prefill and eval (M > 8, int8 mma), at
# TinyLlama's sites and at ragged K (not a multiple of 64) and N
@pytest.mark.parametrize("M", [1, 5, 8, 9, 77, 300, 1024, 2048])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (5632, 2048), (1000, 388),
                                 (256, 132)])
def test_k6_matches_plain(cuda, M, K, N):
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    data, scales, zeros, meta = _w8_site(g, K, N, cuda)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    x[0] = 0  # an all-zero token: the 1e-8 floor of sx
    n0 = k6.w8a8_matmul.launches
    got = k6.w8a8_matmul(x, data, scales, zeros, meta + ("a8",))
    want = k6.w8a8_matmul_plain(x, data, scales, zeros, meta)
    torch.cuda.synchronize()
    assert k6.w8a8_matmul.launches == n0 + 1
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert _k6_err(got, want) < 2e-2
    # the same integer sums and rounding: nearly every bf16 output is equal
    assert float((got == want).float().mean()) >= 0.98
    assert not bool(got[0].any())


@pytest.mark.parametrize("M", [5, 8])
def test_k6_gemv_slices_bounded_by_the_stage(cuda, M):
    """N wide enough for one slice per column tile to fill the card, K one
    4-row group past what a block stages (M x rows <= 32768 bytes of xq):
    the slice is cut to the stage and a second slice takes the rest."""
    from qtpu_torch.kernels import int8_matmul as k6

    K, N = k6.GEMV_STAGE // M // 4 * 4 + 4, 528 * k6.GEMV_COLS
    rows, part = k6.gemv_split(torch.device(cuda), M, K, N)
    assert M * rows <= k6.GEMV_STAGE and part is not None
    g = _gen()
    data, scales, zeros, meta = _w8_site(g, K, N, cuda)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    got = k6.w8a8_matmul(x, data, scales, zeros, meta)
    want = k6.w8a8_matmul_plain(x, data, scales, zeros, meta)
    assert _k6_err(got, want) < 2e-2
    assert float((got == want).float().mean()) >= 0.98


def test_k6_on_strided_batches_and_layer_views(cuda):
    """x [B, T, K] and a layer view W[l] of stacked [L, K, N] weights."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    K, N = 512, 256
    sites = [_w8_site(g, K, N, cuda) for _ in range(3)]
    data = torch.stack([s[0] for s in sites])
    scales = torch.stack([s[1] for s in sites])
    zeros = torch.stack([s[2] for s in sites])
    x = torch.randn(2, 7, K, generator=g, device=cuda).to(torch.bfloat16)
    got = k6.w8a8_matmul(x, data[1], scales[1], zeros[1], sites[1][3])
    want = k6.w8a8_matmul_plain(x, data[1], scales[1], zeros[1], sites[1][3])
    torch.cuda.synchronize()
    assert got.shape == (2, 7, N) and _k6_err(got, want) < 2e-2


def test_k6_raises_on_what_it_does_not_take(cuda):
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    data, scales, zeros, meta = _w8_site(g, 256, 128, cuda)
    x = torch.randn(4, 512, device=cuda).to(torch.bfloat16)[:, ::2]  # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        k6.w8a8_matmul(x, data, scales, zeros, meta)
    with pytest.raises(ValueError, match="bf16"):
        k6.w8a8_matmul(x.contiguous().float(), data, scales, zeros, meta)
    with pytest.raises(ValueError, match="per-channel"):
        k6.w8a8_matmul(x.contiguous(), data, scales, zeros, (8, 64, 256, 128))
    with pytest.raises(ValueError, match="multiples of 4"):
        d, s, z, m = _w8_site(g, 258, 128, cuda)
        k6.w8a8_matmul(torch.zeros(2, 258, dtype=torch.bfloat16, device=cuda), d, s, z, m)


def _tiny_sq_a8():
    """tiny-test packed SmoothQuant W8A8 (calibrated on the CPU), folded
    and fused as the serving path uses it."""
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.models import TINY_TEST, llama
    from qtpu_torch.quant.apply import fold_smooth, fuse_packed_sites, pack_model

    params = llama.init_params(TINY_TEST, seed=2, device="cpu")
    ids = [torch.randint(0, TINY_TEST.vocab_size, (1, 64), generator=torch.Generator().manual_seed(i))
           for i in range(2)]
    stats = collect_calibration_stats(llama.forward, params, ids, TINY_TEST)
    mcfg = {"w_bit": 8, "q_group_size": 64, "alpha": 0.5, "act_quant": True}
    return fuse_packed_sites(*fold_smooth(*pack_model(params, "smoothquant", mcfg, stats)))


def test_w8a8_serving_on_card_matches_cpu(cuda):
    """Prefill + 4 decode steps of a SmoothQuant W8A8 model on the int8 KV
    cache: K6 on every linear (7 per layer + lm_head per call)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.kernels import int8_matmul as k6
    from qtpu_torch.models import TINY_TEST as cfg
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    params, qmeta = _tiny_sq_a8()
    B, T = 3, 20
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(4))

    def run(dev, feed=None):
        p = map_tree(params, lambda t: t.to(dev))
        cache = init_cache(cfg, B, T + 8, quantized=True, device=dev)
        logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta)
        outs, toks = [logits.float().cpu()], []
        pos = torch.full((B,), T, dtype=torch.int32, device=dev)
        for i in range(4):
            tok = torch.argmax(logits, -1).to(torch.int32) if feed is None else feed[i].to(dev)
            toks.append(tok.cpu())
            logits, cache = decode_step(p, tok, pos, cache, cfg, qmeta)
            outs.append(logits.float().cpu())
            pos = pos + 1
        return outs, toks

    want, toks = run("cpu")
    n0 = k6.w8a8_matmul.launches
    got, _ = run("cuda", toks)
    torch.cuda.synchronize()
    assert k6.w8a8_matmul.launches - n0 == 5 * (7 * cfg.num_layers + 1)
    for a, b in zip(got, want):
        assert _rel(a, b) < 3e-2


def test_gptq_sweep_on_card_matches_cpu(cuda):
    """The batched compensated sweep (torch.linalg on the card) against the
    CPU on the same weights and Hessians: the loss within 1%."""
    from qtpu_torch.quant import gptq

    g = torch.Generator().manual_seed(5)
    L, O, C, T = 3, 96, 256, 1024
    X = torch.randn(L, T, 16, generator=g) @ torch.randn(16, C, generator=g)
    X = X + 0.1 * torch.randn(L, T, C, generator=g)
    H = X.transpose(-1, -2) @ X
    W = torch.randn(L, O, C, generator=g)

    def run(dev):
        U = gptq.gptq_prepare_factor(H.to(dev))
        return gptq.gptq_column_sweep(W.to(dev), U, 4, 64, 128).cpu()

    want, got = run("cpu"), run(cuda)
    for l in range(L):
        loss = [float(torch.trace((q[l] - W[l]) @ H[l] @ (q[l] - W[l]).T)) for q in (got, want)]
        assert abs(loss[0] / loss[1] - 1) < 1e-2


# ------------------------------------------------- K9, K10, K11 (sparse MoE)
def _experts(g, E, K, N, bits, group, dev, sym=False, L=None):
    """E experts' random [K, N] weights packed ([L, E, ...] with L)."""
    n = E if L is None else L * E
    parts = [quantize_pack(torch.randn(K, N, generator=g, device=dev) * 0.02, bits, group, sym)
             for _ in range(n)]
    shape = (E,) if L is None else (L, E)

    def stack(f):
        return torch.stack([f(p) for p in parts]).reshape(*shape, *f(parts[0]).shape)

    return stack(lambda p: p.data), stack(lambda p: p.scales), \
        None if sym else stack(lambda p: p.zeros)


@pytest.mark.parametrize("M", [1, 8, 77, 300])
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("bits,group,sym", [(4, 128, False), (4, 64, True), (8, 64, False),
                                            (2, 32, False)])  # W2 g32: the GEMV at M > 8
def test_k9_matches_plain(cuda, M, per_expert, bits, group, sym):
    g = _gen()
    E, L, K, N = 4, 3, 512, 384
    data, scales, zeros = _experts(g, E, K, N, bits, group, cuda, sym, L=L)
    x = torch.randn(*((E,) if per_expert else ()), M, K, generator=g, device=cuda)
    x = x.to(torch.bfloat16)
    meta = (bits, group, K, N)
    z = None if zeros is None else zeros[1]
    n0 = k9.moe_matmul.launches
    got = k9.moe_matmul(x, data[1], scales[1], z, meta, per_expert_input=per_expert)
    want = k9.moe_matmul_plain(x, data[1], scales[1], z, meta, per_expert_input=per_expert)
    torch.cuda.synchronize()
    assert k9.moe_matmul.launches == n0 + 1
    assert tuple(got.shape) == (E, M, N)
    assert _rel(got, want) < 2e-2


# Mixtral-8x7B's expert sites (E 8: gate/up 4096 x 14336, down 14336 x 4096)
# at decode and prefill M, and one Qwen2-57B-A14B site (E 64, 3584 x 2560)
@pytest.mark.parametrize("E,K,N,M,per_expert", [
    (8, 4096, 14336, 8, False), (8, 14336, 4096, 8, True), (8, 4096, 14336, 1024, False),
    (8, 14336, 4096, 1024, True), (64, 3584, 2560, 8, False), (64, 2560, 3584, 64, True),
])
def test_k9_at_full_width(cuda, E, K, N, M, per_expert):
    g = _gen()
    data, scales, zeros = _experts(g, E, K, N, 4, 128, cuda)
    x = torch.randn(*((E,) if per_expert else ()), M, K, generator=g, device=cuda)
    x = x.to(torch.bfloat16)
    meta = (4, 128, K, N)
    got = k9.moe_matmul(x, data, scales, zeros, meta, per_expert_input=per_expert)
    want = k9.moe_matmul_plain(x, data, scales, zeros, meta, per_expert_input=per_expert)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("Gs", [1, 4, 6, 16])
@pytest.mark.parametrize("bits,group", [(4, 64), (4, 128), (8, 128), (2, 32)])
def test_k10_matches_plain(cuda, Gs, bits, group):
    g = _gen()
    E, L, K, N = 4, 2, 512, 384
    data, scales, zeros = _experts(g, E, K, N, bits, group, cuda, L=L)
    x = torch.randn(Gs, K, generator=g, device=cuda).to(torch.bfloat16)
    eidx = torch.tensor([2, 0, 2, 3, 1, 2, 3, 3] * 2, dtype=torch.int32, device=cuda)[:Gs]
    meta = (bits, group, K, N)
    w = k9.moe_gathered_matmul
    n0, t0, s0 = w.launches, w.gemv_tc_launches, w.gemv_launches
    got = w(x, eidx, data[1], scales[1], zeros[1], meta)
    want = k9.moe_gathered_matmul_plain(x, eidx, data[1], scales[1], zeros[1], meta)
    was = k9.moe_gathered_matmul_simt(x, eidx, data[1], scales[1], zeros[1], meta)
    torch.cuda.synchronize()
    assert w.launches == n0 + 1
    ptrs = [t[1].data_ptr() for t in (data, scales, zeros)]
    route = k9.gathered_route(Gs, K, N, bits, group, ptrs)
    assert route == ("gemv" if bits == 2 else "gemv_tc")
    assert (w.gemv_tc_launches - t0, w.gemv_launches - s0) == ((1, 0) if route == "gemv_tc"
                                                               else (0, 1))
    for ref in (want, was):  # the plain version and dq_core's body on the same bytes
        err = float((got.float() - ref.float()).abs().max() / (ref.float().abs().max() + 1e-6))
        assert err < 2e-2
    if route == "gemv_tc":  # the tensor-core body gives the same bits call after call
        assert _same_bits(got, w(x, eidx, data[1], scales[1], zeros[1], meta))


@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096)])
def test_k10_at_full_width(cuda, K, N):
    g = _gen()
    data, scales, zeros = _experts(g, 8, K, N, 4, 128, cuda)
    x = torch.randn(4, K, generator=g, device=cuda).to(torch.bfloat16)
    eidx = torch.tensor([5, 1, 5, 7], dtype=torch.int32, device=cuda)
    t0 = k9.moe_gathered_matmul.gemv_tc_launches
    got = k9.moe_gathered_matmul(x, eidx, data, scales, zeros, (4, 128, K, N))
    want = k9.moe_gathered_matmul_plain(x, eidx, data, scales, zeros, (4, 128, K, N))
    torch.cuda.synchronize()
    assert k9.moe_gathered_matmul.gemv_tc_launches == t0 + 1
    assert _rel(got, want) < 2e-2
    assert _same_bits(got, k9.moe_gathered_matmul(x, eidx, data, scales, zeros, (4, 128, K, N)))


@pytest.mark.parametrize("K,N", [(512, 384), (14336, 4096)])
@pytest.mark.parametrize("slots", [[2] * 12, [1] * 9 + [0, 3, 0] + [1] * 8])
def test_k10_many_slots_on_one_expert_take_several_leaders(cuda, K, N, slots):
    """12 slots on one expert (two leaders: slots 0 and 8), and 17 of 20
    on one (three leaders), on the tensor-core body: within K1's tolerance
    of the plain version."""
    g = _gen()
    data, scales, zeros = _experts(g, 4, K, N, 4, 128, cuda)
    x = torch.randn(len(slots), K, generator=g, device=cuda).to(torch.bfloat16)
    eidx = torch.tensor(slots, dtype=torch.int32, device=cuda)
    t0 = k9.moe_gathered_matmul.gemv_tc_launches
    got = k9.moe_gathered_matmul(x, eidx, data, scales, zeros, (4, 128, K, N))
    want = k9.moe_gathered_matmul_plain(x, eidx, data, scales, zeros, (4, 128, K, N))
    torch.cuda.synchronize()
    assert k9.moe_gathered_matmul.gemv_tc_launches == t0 + 1
    assert _rel(got, want) < 2e-2


def test_k10_rows_out_of_range_stay_untouched(cuda):
    """The tensor-core body (its C entry on an output filled beforehand)
    leaves the rows of expert ids outside [0, E) as they were and writes the
    others as the plain version does."""
    from qtpu_torch.kernels import _build

    g = _gen()
    E, K, N = 4, 1024, 384
    data, scales, zeros = _experts(g, E, K, N, 4, 128, cuda)
    slots = [3, -1, 3, E, 0, 7, 3, -5]
    x = torch.randn(len(slots), K, generator=g, device=cuda).to(torch.bfloat16)
    eidx = torch.tensor(slots, dtype=torch.int32, device=cuda)
    out = torch.full((len(slots), N), 7.0, dtype=torch.bfloat16, device=cuda)
    cluster, per = k1.gemv_tc_split(cuda, K, N, 128, tiles=-(-N // 128) * len(slots))
    lib = _build.load("moe_matmul", k9._SIG)
    rc = lib.qtpu_moe_gathered(x.data_ptr(), eidx.data_ptr(), data.data_ptr(), scales.data_ptr(),
                               zeros.data_ptr(), out.data_ptr(), None, per, cluster, E,
                               len(slots), K, N, 4, 128, _build.stream_of(x))
    torch.cuda.synchronize()
    assert rc == 0
    inside = [i for i, e in enumerate(slots) if 0 <= e < E]
    outside = [i for i in range(len(slots)) if i not in inside]
    assert bool((out[outside] == 7.0).all())
    sub = torch.tensor(inside, device=cuda)
    want = k9.moe_gathered_matmul_plain(x[sub], eidx[sub], data, scales, zeros, (4, 128, K, N))
    assert _rel(out[sub], want) < 2e-2


def test_k10_is_one_cuda_launch(cuda):
    """A graph of 4 calls holds one moe_gathered_tc_kernel a call (no
    finishing launch); dq_core's body adds its split-K finish."""
    g = _gen()
    K, N = 4096, 1024
    data, scales, zeros = _experts(g, 8, K, N, 4, 128, cuda)
    x = torch.randn(4, K, generator=g, device=cuda).to(torch.bfloat16)
    eidx = torch.tensor([1, 6, 3, 6], dtype=torch.int32, device=cuda)
    m = (4, 128, K, N)
    for wrapper, kernels in ((k9.moe_gathered_matmul, {"moe_gathered_tc_kernel"}),
                             (k9.moe_gathered_matmul_simt, {"moe_gemv_kernel", "moe_finish"})):
        wrapper(x, eidx, data, scales, zeros, m)
        torch.cuda.synchronize()
        seen = _graph_kernels(lambda wrapper=wrapper: wrapper(x, eidx, data, scales, zeros, m), 4)
        seen = {n: c for n, c in seen.items() if "moe_" in n}
        assert {next(k for k in kernels if k + "(" in n or k + "<" in n) for n in seen} == kernels
        assert all(c == 4 for c in seen.values()), seen


def test_k10_and_k2_replay_in_a_cuda_graph_without_a_host_sync(cuda):
    """K10 on the tensor-core body and K2 on programmatic dependent launch
    (right after the kernel that writes its k/v rows: the graph's
    programmatic edge), captured in a CUDA graph: a replay on new inputs
    gives what eager calls on those inputs give, with no host sync."""
    g = _gen()
    K, N = 1024, 512
    ex = _experts(g, 4, K, N, 4, 128, cuda)
    x = torch.randn(4, K, generator=g, device=cuda).to(torch.bfloat16)
    eidx = torch.tensor([2, 0, 2, 3], dtype=torch.int32, device=cuda)
    m = (4, 128, K, N)
    L, B, KV, S, hd = 2, 4, 2, 40, 128
    cache = _cache(g, L, B, KV, S, hd, cuda)
    src = torch.randn(2, B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.empty_like(src)
    pos = torch.tensor([0, 17, S - 1, S], dtype=torch.int32, device=cuda)

    def step():
        torch.mul(src, 2.0, out=kv)  # the kernel K2 overlaps: it writes K2's inputs
        k23.cache_band_write(kv[0], kv[1], *cache, pos, 1)
        return k9.moe_gathered_matmul(x, eidx, *ex, m)

    new = (torch.randn(4, K, generator=g, device=cuda).to(torch.bfloat16),
           torch.tensor([1, 1, 3, -1], dtype=torch.int32, device=cuda),
           torch.randn(2, B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        for t, v in zip((x, eidx, src), new):
            t.copy_(v)
        ref = [t.clone() for t in cache]
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    k23.cache_band_write_plain(2.0 * src[0], 2.0 * src[1], *ref, pos, 1)
    for a, b in zip(cache[:2], ref[:2]):
        d = (a.int() - b.int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= 2
    for a, b in zip(cache[2:], ref[2:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    eager = k9.moe_gathered_matmul(x, eidx, *ex, m)
    torch.cuda.synchronize()
    assert _same_bits(out[:3], eager[:3])  # slot 3's expert id is out of range


def test_k9_k10_raise_on_what_they_do_not_take(cuda):
    g = _gen()
    data, scales, zeros = _experts(g, 2, 256, 128, 4, 64, cuda)
    x = torch.randn(4, 512, device=cuda).to(torch.bfloat16)[:, ::2]  # not contiguous
    meta = (4, 64, 256, 128)
    with pytest.raises(ValueError):
        k9.moe_matmul(x, data, scales, zeros, meta)
    with pytest.raises(ValueError):  # per-expert input with another expert count
        k9.moe_matmul(x.contiguous()[None].expand(3, 4, 256).contiguous(), data, scales, zeros,
                      meta, per_expert_input=True)
    with pytest.raises(ValueError):  # expert ids must be int32 on the card
        k9.moe_gathered_matmul(x.contiguous(), torch.zeros(4, dtype=torch.int64, device=cuda),
                               data, scales, zeros, meta)


@pytest.mark.parametrize("window", [0, 16, 48])
@pytest.mark.parametrize("S", [40, 128, 176, 192, 200])
@pytest.mark.parametrize("hd,KV,G", [(64, 4, 4), (128, 8, 4), (64, 2, 1), (128, 1, 32),
                                     (128, 8, 1), (64, 4, 8), (128, 2, 8), (64, 1, 32),
                                     (48, 2, 4), (80, 8, 1), (80, 4, 4), (80, 1, 32), (96, 8, 4),
                                     (112, 2, 8), (40, 2, 4), (136, 2, 4), (256, 4, 3),
                                     (64, 1, 48), (256, 1, 48)])
def test_k11_matches_plain(cuda, window, S, hd, KV, G):
    """The codes and scales K11 writes equal the plain write's (an inactive
    slot at pos = S writes nothing); the output within rtol/atol 2e-2 of f32
    math on the written cache (qtpu's test of the TPU kernel) and within 2e-2
    relative error of the plain version, which rounds the probabilities and
    the dequantized cache to bf16."""
    g = _gen()
    L, B = 2, 8
    H = KV * G
    cache = _cache(g, L, B, KV, S, hd, cuda)
    q = torch.randn(B, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor(_boundary_pos(S, S), dtype=torch.int32, device=cuda)  # last: inactive
    kc, pc = [t.clone() for t in cache], [t.clone() for t in cache]
    n0 = k23.decode_attention_write.launches
    got = k23.decode_attention_write(q, kn, vn, *kc, pos, 1, window=window)
    want = k23.decode_attention_write_plain(q, kn, vn, *pc, pos, 1, window=window)
    torch.cuda.synchronize()
    assert k23.decode_attention_write.launches == n0 + 1
    for a, b in zip(kc, pc):
        assert torch.equal(a, b)
    want32 = k23.decode_attention_write_plain(q.float(), kn, vn, *pc, pos, 1, window=window)
    torch.testing.assert_close(got[:-1].float(), want32[:-1], rtol=2e-2, atol=2e-2)
    assert _rel(got[:-1], want[:-1]) < 2e-2
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "int8_per_layer"])
@pytest.mark.parametrize("B", [1, 4])
def test_moe_decode_on_card_matches_cpu(cuda, kv, B):
    """Packed W4 TINY_MOE_TEST, prefill and 3 teacher-forced decode steps on
    the card against the CPU's plain versions: B = 1 decodes on the gathered
    route (K10, no host synchronization in the step), B = 4 on the grouped
    one (K9); once per layer of a step K11 (int8), K8 (bf16), or K12 (the
    per-layer int8 cache at S 2048, through moe.forward_with_cache)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models.config import TINY_MOE_TEST as cfg
    from qtpu_torch.models import moe
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    params, qmeta = pack_model(moe.init_params(cfg, device="cpu"), "rtn",
                               {"w_bit": 4, "q_group_size": 64}, arch="moe")
    ids = torch.randint(0, cfg.vocab_size, (B, 12), generator=torch.Generator().manual_seed(2))
    outs, L = {}, cfg.num_layers
    for dev in ("cpu", "cuda"):
        p = map_tree(params, lambda t: t.to(dev))
        per_layer = kv == "int8_per_layer"
        cache = init_cache(cfg, B, 2048 if per_layer else 24, quantized=kv != "bfloat16",
                           device=dev, per_layer=per_layer)
        logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta, arch="moe")
        res, pos = [logits.float().cpu()], torch.full((B,), 12, dtype=torch.int32, device=dev)
        toks = [ids[:, i].to(torch.int32).to(dev) for i in range(3)]
        n0 = (k9.moe_matmul.launches, k9.moe_gathered_matmul.launches,
              k23.decode_attention_write.launches, k23.decode_attention_write_bf16.launches,
              k23.decode_attention_flash.launches)
        for i in range(3):
            if dev == "cuda" and B == 1:
                torch.cuda.set_sync_debug_mode("error")  # any host synchronization raises
            try:
                logits, cache = decode_step(p, toks[i], pos, cache, cfg, qmeta, arch="moe")
            finally:
                torch.cuda.set_sync_debug_mode("default")
            res.append(logits.float().cpu())
            pos = pos + 1
        if dev == "cuda":
            gathered = B * cfg.num_experts_per_tok < cfg.num_experts
            assert k9.moe_matmul.launches - n0[0] == (0 if gathered else 3 * 3 * L)
            assert k9.moe_gathered_matmul.launches - n0[1] == (3 * 3 * L if gathered else 0)
            assert k23.decode_attention_write.launches - n0[2] == (3 * L if kv == "int8" else 0)
            assert k23.decode_attention_write_bf16.launches - n0[3] == (3 * L if kv == "bfloat16" else 0)
            assert k23.decode_attention_flash.launches - n0[4] == (3 * L if per_layer else 0)
        outs[dev] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) < 3e-2


def _flash_inputs(g, B, KV, G, hd, dev):
    q = torch.randn(B, KV * G, hd, generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn(B, 1, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    vn = torch.randn(B, 1, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    return q, kn, vn


@pytest.mark.parametrize("window", [0, 100, 3000, 64])
@pytest.mark.parametrize("S,hd,KV,G", [(2048, 64, 4, 8), (4096, 128, 8, 4), (2048, 32, 2, 1),
                                       (2048, 64, 1, 32), (2048, 64, 2, 1), (2048, 128, 2, 1),
                                       (2048, 128, 2, 8), (2048, 128, 1, 32), (2048, 48, 2, 4),
                                       (2048, 80, 8, 1), (4096, 80, 4, 8), (2048, 80, 1, 32),
                                       (2048, 96, 8, 4), (2048, 112, 2, 1), (4096, 40, 2, 4),
                                       (4096, 136, 2, 4), (4096, 256, 4, 3), (4096, 64, 1, 48),
                                       (2048, 256, 1, 48), (2048, 8, 2, 4)])
def test_k12_flash_matches_plain(cuda, window, S, hd, KV, G):
    """K12's flash entry on a per-layer buffer: the codes and scales it
    writes equal the plain version's (an inactive slot at pos >= S writes
    nothing and attends over all of S without the new token), the output
    within 2e-2 relative error of the plain version (f32 math, the same
    function)."""
    g = _gen()
    B = 8
    k, v, ks, vs = (t[0] for t in _cache(g, 1, B, KV, S, hd, cuda))
    q, kn, vn = _flash_inputs(g, B, KV, G, hd, cuda)
    # the first rows, pos on a chunk or slice boundary and past it, the last
    # row, an inactive slot
    pos = torch.tensor([0, 37, 64, 65, S // 2, S // 2 + 1, S - 1, S + 3], dtype=torch.int32,
                       device=cuda)
    kc = [t.clone() for t in (k, v, ks, vs)]
    pc = [t.clone() for t in (k, v, ks, vs)]
    n0 = k23.decode_attention_flash.launches
    got = k23.decode_attention_flash(q, kn, vn, *kc, pos, window=window)
    want = k23.flash_decode_plain(q, kn, vn, *pc, pos, window=window)
    torch.cuda.synchronize()
    assert k23.decode_attention_flash.launches == n0 + 1
    for a, b in zip(kc, pc):
        assert torch.equal(a, b)
    assert _rel(got, want) < 2e-2
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.parametrize("S", [40, 128, 176, 192, 264])
def test_k12_banded_entries_match_plain(cuda, S):
    """The banded entry at any S % 8 and the stacked one on layer 1 of a
    3-layer cache (the other layers untouched)."""
    g = _gen()
    L, B, KV, G, hd = 3, 4, 4, 8, 64
    cache = _cache(g, L, B, KV, S, hd, cuda)
    q, kn, vn = _flash_inputs(g, B, KV, G, hd, cuda)
    pos = torch.tensor([5, 17, S - 1, S], dtype=torch.int32, device=cuda)
    kc, pc = [t.clone() for t in cache], [t.clone() for t in cache]
    got = k23.decode_attention_write_banded_stacked(q, kn, vn, *kc, pos, 1, window=16)
    want = k23.flash_decode_plain(q, kn, vn, *(t[1] for t in pc), pos, window=16)
    torch.cuda.synchronize()
    for a, b, orig in zip(kc, pc, cache):
        assert torch.equal(a, b)
        assert torch.equal(a[0], orig[0]) and torch.equal(a[2], orig[2])
    assert _rel(got, want) < 2e-2
    one = [t[2].clone() for t in cache]
    got = k23.decode_attention_write_banded(q, kn, vn, *one, pos)
    want = k23.flash_decode_plain(q, kn, vn, *(t[2] for t in pc), pos)
    torch.cuda.synchronize()
    for a, b in zip(one, (t[2] for t in pc)):
        assert torch.equal(a, b)
    assert _rel(got, want) < 2e-2


def test_k12_raises_on_what_it_does_not_take(cuda):
    g = _gen()
    k, v, ks, vs = (t[0] for t in _cache(g, 1, 2, 2, 2048, 36, cuda))
    q, kn, vn = _flash_inputs(g, 2, 2, 2, 36, cuda)
    pos = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        k23.decode_attention_flash(q, kn, vn, k, v, ks, vs, pos)
    with pytest.raises(NotImplementedError):  # the flash entry's S granule
        k23.decode_attention_flash(q, kn, vn, k[:, :, :1024], v, ks, vs, pos)
    k, v, ks, vs = (t[0] for t in _cache(g, 1, 2, 2, 2048, 64, cuda))
    q, kn, vn = _flash_inputs(g, 2, 2, 2, 64, cuda)
    with pytest.raises(ValueError, match="int32"):
        k23.decode_attention_flash(q, kn, vn, k, v, ks, vs, pos.long())


# The attention kernels over their whole domain: every head dim that is a
# multiple of 8 from 8 to 256 at 8 q heads over 2 kv heads, and 3 to 100 q
# heads a kv head at hd 40, 64, 128 and 256 (past 32 a decode block's heads
# go to a grid axis of head groups); rel 2e-2 against the plain versions.
def _domain_k5(g, dev, hd, H, KV, S, window):
    """K5 on its Hopper body (one launch) and its mma.sync body."""
    from qtpu_torch.kernels import flash_attention as k5

    q, k, v = _bf16_qkv(g, 1, H, KV, S, hd, dev)
    w0 = k5.flash_attention.wgmma_launches
    got = k5.flash_attention(q, k, v, window)
    launched = k5.flash_attention.wgmma_launches - w0
    was = k5.flash_attention_mma(q, k, v, window)
    want = k5.flash_attention_plain(q, k, v, window)
    torch.cuda.synchronize()
    assert launched == 1
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) < 2e-2 and _rel(was, want) < 2e-2


def _domain_decode(g, dev, hd, KV, G, S, window):
    """K3, the one-layer entry, K11 (int8) and K8 (bf16) on layer 1 of 2 at
    B 8, positions from 0 to S (an inactive slot, whose row is not held);
    the writes equal the plain ones."""
    L, B, H = 2, 8, KV * G
    pos = torch.tensor([0, 9, S // 2, min(63, S - 1), min(64, S - 1), min(65, S - 1), S - 1, S],
                       dtype=torch.int32, device=dev)
    q, kn, vn = _flash_inputs(g, B, KV, G, hd, dev)
    c = _cache(g, L, B, KV, S, hd, dev)
    want = k23.decode_attention_plain(q, *c, pos, 1, window=window)
    got = k23.decode_attention(q, *c, pos, 1, window=window)
    assert _rel(got[:-1], want[:-1]) < 2e-2
    got = k23.decode_attention_layer(q, *(t[1] for t in c), pos, window=window)
    assert _rel(got[:-1], want[:-1]) < 2e-2
    kc, pc = [t.clone() for t in c], [t.clone() for t in c]
    got = k23.decode_attention_write(q, kn, vn, *kc, pos, 1, window=window)
    want = k23.decode_attention_write_plain(q, kn, vn, *pc, pos, 1, window=window)
    assert _rel(got[:-1], want[:-1]) < 2e-2
    assert all(torch.equal(a, b) for a, b in zip(kc, pc))
    kb = torch.randn(L, B, KV, S, hd, generator=g, device=dev).to(torch.bfloat16)
    vb = torch.randn(L, B, KV, S, hd, generator=g, device=dev).to(torch.bfloat16)
    kc, vc, kp, vp = kb.clone(), vb.clone(), kb.clone(), vb.clone()
    got = k23.decode_attention_write_bf16(q, kn, vn, kc, vc, pos, 1, window=window)
    want = k23.decode_attention_write_bf16_plain(q, kn, vn, kp, vp, pos, 1, window=window)
    torch.cuda.synchronize()
    assert _rel(got[:-1], want[:-1]) < 2e-2
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


def _domain_k12(g, dev, hd, KV, G, S, window):
    """K12's flash entry on a per-layer buffer at B 8, an inactive slot past
    S included; the writes equal the plain ones."""
    B = 8
    k, v, ks, vs = (t[0] for t in _cache(g, 1, B, KV, S, hd, dev))
    q, kn, vn = _flash_inputs(g, B, KV, G, hd, dev)
    pos = torch.tensor([0, 37, 64, 65, S // 2, S // 2 + 1, S - 1, S + 3], dtype=torch.int32,
                       device=dev)
    kc = [t.clone() for t in (k, v, ks, vs)]
    pc = [t.clone() for t in (k, v, ks, vs)]
    got = k23.decode_attention_flash(q, kn, vn, *kc, pos, window=window)
    want = k23.flash_decode_plain(q, kn, vn, *pc, pos, window=window)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2
    assert all(torch.equal(a, b) for a, b in zip(kc, pc))


@pytest.mark.parametrize("hd", range(8, 264, 8))
def test_attention_kernels_take_every_head_dim(cuda, hd):
    g = _gen()
    for window in (0, 100):
        _domain_k5(g, cuda, hd, 8, 2, 300, window)
        _domain_k12(g, cuda, hd, 2, 4, 2048, window)
    for window in (0, 16):
        _domain_decode(g, cuda, hd, 2, 4, 200, window)


@pytest.mark.parametrize("G", [3, 17, 33, 48, 64, 100])
@pytest.mark.parametrize("hd", [40, 64, 128, 256])
def test_attention_kernels_take_any_group(cuda, hd, G):
    g = _gen()
    _domain_k5(g, cuda, hd, G, 1, 300, 0)
    _domain_decode(g, cuda, hd, 1, G, 200, 0)
    _domain_k12(g, cuda, hd, 1, G, 2048, 0)


@pytest.mark.parametrize("window", [0, 64, 1])
@pytest.mark.parametrize("S", [176, 128, 192])
@pytest.mark.parametrize("hd,KV,G", [(64, 12, 1), (64, 4, 8), (128, 8, 4), (128, 2, 1),
                                     (128, 2, 8), (64, 1, 32), (128, 1, 32), (80, 32, 1),
                                     (48, 4, 8), (96, 8, 4), (112, 2, 1), (32, 4, 4),
                                     (40, 2, 4), (136, 2, 4), (256, 4, 3), (64, 1, 48)])
def test_row9_layer_entry_matches_plain(cuda, window, S, hd, KV, G):
    """decode_attention_layer on one layer [B, KV, S, hd] (GPT-2's MHA at
    hd 64 and G 1 first): read-only, within 2e-2 of the plain version and
    rtol/atol 2e-2 of f32 math."""
    g = _gen()
    B = 8
    k, v, ks, vs = (t[1] for t in _cache(g, 2, B, KV, S, hd, cuda))
    before = [t.clone() for t in (k, v, ks, vs)]
    q = torch.randn(B, KV * G, hd, generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.tensor([*(min(p, S - 1) for p in (63, 64, 65, 127, 128, 170)), S - 1, S],
                       dtype=torch.int32, device=cuda)
    n0 = k23.decode_attention_layer.launches
    got = k23.decode_attention_layer(q, k, v, ks, vs, pos, window=window)
    want = k23.decode_attention_layer(q.cpu(), *(t.cpu() for t in (k, v, ks, vs)), pos.cpu(),
                                      window=window)
    want32 = k23.decode_attention_plain(q.float(), *(t[None] for t in (k, v, ks, vs)), pos, 0,
                                        window=window)
    torch.cuda.synchronize()
    assert k23.decode_attention_layer.launches == n0 + 1
    for a, b in zip((k, v, ks, vs), before):
        assert torch.equal(a, b)
    assert _rel(got[:-1].cpu(), want[:-1]) < 2e-2
    torch.testing.assert_close(got[:-1].float(), want32[:-1], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hd,KV,G", [(64, 4, 8), (128, 8, 4), (64, 12, 1), (128, 1, 32)])
def test_new_and_earlier_decode_bodies_write_the_same_rows(cuda, hd, KV, G):
    """K3's kernel (K11 on the int8 cache, K8 on the bf16 one) and K12 write
    the same codes, scales and rows as their earlier bodies (the `_simt`
    entries chip_smoke.py times as "was"), and both outputs agree."""
    g = _gen()
    L, B, S = 2, 8, 200
    cache = _cache(g, L, B, KV, S, hd, cuda)
    q, kn, vn = _flash_inputs(g, B, KV, G, hd, cuda)
    pos = torch.tensor(_boundary_pos(S, S + 3), dtype=torch.int32, device=cuda)
    new, old = [t.clone() for t in cache], [t.clone() for t in cache]
    got = k23.decode_attention_write(q, kn, vn, *new, pos, 1, window=48)
    was = k23.decode_attention_write_simt(q, kn, vn, *old, pos, 1, window=48)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert _rel(got[:-1], was[:-1]) < 2e-2
    kb, vb = (torch.randn(L, B, KV, S, hd, generator=g, device=cuda).to(torch.bfloat16)
              for _ in range(2))
    new, old = [kb.clone(), vb.clone()], [kb.clone(), vb.clone()]
    got = k23.decode_attention_write_bf16(q, kn, vn, *new, pos, 0)
    was = k23.decode_attention_write_bf16_simt(q, kn, vn, *old, pos, 0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert _rel(got[:-1], was[:-1]) < 2e-2
    new, old = [t[0].clone() for t in cache], [t[0].clone() for t in cache]
    got = k23.decode_attention_write_banded(q, kn, vn, *new, pos, window=100)
    was = k23.flash_decode_simt(q, kn, vn, *old, pos, window=100)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(new, old))
    assert _rel(got, was) < 2e-2


@pytest.mark.parametrize("M", [1, 8, 77, 300])
@pytest.mark.parametrize("bits,group,N", [(4, 128, 50257), (4, 64, 771), (8, 64, 257),
                                          (2, 32, 385)])
def test_k1_at_ragged_n_matches_plain(cuda, M, bits, group, N):
    """K1 at N % 4 != 0 (GPT-2's lm_head first): both the GEMV and the
    tensor-core path mask the ragged column tail."""
    g = _gen()
    K = 768 if N == 50257 else 512
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, bits, group)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (bits, group, K, N)
    got = k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta)
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("M", [1, 77])
def test_k7_at_ragged_n_matches_plain(cuda, M):
    from qtpu_torch.kernels import codebook_matmul as k7

    g = _gen()
    K, N, group = 512, 387, 64
    data, sc, cb = _pot_site(g, K, N, group, cuda)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    got = k7.codebook_matmul(x, data, sc, cb, (4, group, K, N))
    want = k7.codebook_matmul_plain(x, data, sc, cb, (4, group, K, N))
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2


def test_per_layer_decode_on_card_matches_cpu(cuda):
    """TINY_TEST RTN W4 fused on the per-layer int8 cache at S 2048: prefill
    and 3 teacher-forced decode steps on the card (K12 once per layer of a
    step, with no host synchronization in the step) against the CPU's plain
    versions."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINY_TEST as cfg
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    params, qmeta = fuse_packed_sites(*pack_model(llama.init_params(cfg, device="cpu"), "rtn",
                                                  {"w_bit": 4, "q_group_size": 64}))
    B, T = 4, 12
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(2))
    outs, L = {}, cfg.num_layers
    for dev in ("cpu", "cuda"):
        p = map_tree(params, lambda t: t.to(dev))
        cache = init_cache(cfg, B, 2048, quantized=True, device=dev, per_layer=True)
        logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta)
        res, pos = [logits.float().cpu()], torch.full((B,), T, dtype=torch.int32, device=dev)
        toks = [ids[:, i].to(torch.int32).to(dev) for i in range(3)]
        n0 = k23.decode_attention_flash.launches
        for i in range(3):
            if dev == "cuda":
                torch.cuda.set_sync_debug_mode("error")  # any host synchronization raises
            try:
                logits, cache = decode_step(p, toks[i], pos, cache, cfg, qmeta)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            res.append(logits.float().cpu())
            pos = pos + 1
        if dev == "cuda":
            assert k23.decode_attention_flash.launches - n0 == 3 * L
        outs[dev] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) < 3e-2


@pytest.mark.parametrize("arch", ["gpt2", "opt"])
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_gpt2_opt_decode_on_card_matches_cpu(cuda, arch, kv):
    """Packed W4 TINY_GPT2_TEST / TINY_OPT_TEST, prefill and 3 teacher-forced
    decode steps on the card against the CPU: on the int8 cache K2 and the
    one-layer entry once per layer of a step, on the bf16 cache K8."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import config, get_arch
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    cfg = {"gpt2": config.TINY_GPT2_TEST, "opt": config.TINY_OPT_TEST}[arch]
    params, qmeta = fuse_packed_sites(
        *pack_model(get_arch(arch).init_params(cfg, device="cpu"), "rtn",
                    {"w_bit": 4, "q_group_size": 64}, arch=arch), arch=arch)
    B, T = 4, 12
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(2))
    outs, L = {}, cfg.num_layers
    for dev in ("cpu", "cuda"):
        p = map_tree(params, lambda t: t.to(dev))
        cache = init_cache(cfg, B, 24, quantized=kv == "int8", device=dev)
        logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta, arch=arch)
        res, pos = [logits.float().cpu()], torch.full((B,), T, dtype=torch.int32, device=dev)
        n0 = (k23.decode_attention_layer.launches, k23.decode_attention_write_bf16.launches)
        for i in range(3):
            logits, cache = decode_step(p, ids[:, i].to(torch.int32).to(dev), pos, cache, cfg,
                                        qmeta, arch=arch)
            res.append(logits.float().cpu())
            pos = pos + 1
        if dev == "cuda":
            assert k23.decode_attention_layer.launches - n0[0] == (3 * L if kv == "int8" else 0)
            assert k23.decode_attention_write_bf16.launches - n0[1] == (3 * L if kv != "int8"
                                                                          else 0)
        outs[dev] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) < 3e-2


def _k1_option_inputs(g, dev, bits, group, sym, M, K=512, N=384):
    qt = quantize_pack(torch.randn(K, N, generator=g, device=dev) * 0.02, bits, group, sym)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    nw = (1.0 + 0.1 * torch.randn(K, generator=g, device=dev)).to(torch.bfloat16)
    r = torch.randn(M, N, generator=g, device=dev).to(torch.bfloat16)
    return qt, x, nw, r, (bits, group, K, N)


@pytest.mark.parametrize("option", ["norm_w", "resid", "both"])
@pytest.mark.parametrize("bits,group,sym", [(4, 128, False), (4, 64, True), (8, 64, False),
                                            (2, 32, False), (2, 128, True)])
@pytest.mark.parametrize("M", [1, 8, 13, 32, 77, 300])
def test_k1_options_match_plain(cuda, option, bits, group, sym, M):
    """K1 with qtpu's norm_w / resid options against the plain composition,
    rel 2e-2: at M <= 8 the GEMVs (the tensor-core GEMV's MODE 4, 2, 6 or
    dq_core's split K), above 8 rows the Hopper route's OPT instances, one
    launch on the wgmma counter. W2 g32 above 8 rows has no body with the
    options (options_supported says so) and raises."""
    qt, x, nw, r, meta = _k1_option_inputs(_gen(), cuda, bits, group, sym, M)
    kw = {"norm_w": nw if option != "resid" else None, "resid": r if option != "norm_w" else None}
    if not k1.options_supported(meta, M):
        assert M > 8 and group not in k1.WGMMA_GROUPS
        with pytest.raises(ValueError):
            k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, **kw)
        return
    n0 = (k1.quantized_matmul.launches, k1.quantized_matmul.norm_launches,
          k1.quantized_matmul.resid_launches)
    got, route = _route_and_out(
        k1.quantized_matmul, lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta,
                                                         **kw))
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta, **kw)
    torch.cuda.synchronize()
    assert (k1.quantized_matmul.launches - n0[0], k1.quantized_matmul.norm_launches - n0[1],
            k1.quantized_matmul.resid_launches - n0[2]) == (
        1, int(kw["norm_w"] is not None), int(kw["resid"] is not None))
    assert (route == "wgmma") == (M > 8)
    base = r.float() if kw["resid"] is not None else 0.0
    assert _rel(got.float() - base, want.float() - base) < 2e-2


@pytest.mark.parametrize("site", ["qkv", "o"])
@pytest.mark.parametrize("M", [1024, 2048])
def test_k1_options_on_the_hopper_route_at_prefill(cuda, site, M):
    """K1 with norm_w (qkv) or resid (o) at TinyLlama's prefill and eval
    shapes on the Hopper route, against the plain composition (rel 2e-2)
    and the composed chain on the kernel (rms_norm + K1, K1 + add), two
    calls giving the same bits."""
    from qtpu_torch.models.ops import rms_norm

    g = _gen()
    K, N = TINYLLAMA_SITES[site]
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, 4, 128, False)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (4, 128, K, N)
    nw = (1.0 + 0.1 * torch.randn(K, generator=g, device=cuda)).to(torch.bfloat16)
    r = torch.randn(M, N, generator=g, device=cuda).to(torch.bfloat16)
    kw = {"norm_w": nw, "eps": 1e-5} if site == "qkv" else {"resid": r}
    call = lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, **kw)  # noqa: E731
    got, route = _route_and_out(k1.quantized_matmul, call)
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta, **kw)
    if site == "qkv":
        chain = k1.quantized_matmul(rms_norm(x, nw, 1e-5), qt.data, qt.scales, qt.zeros, meta)
    else:
        chain = r + k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta)
    torch.cuda.synchronize()
    assert route == "wgmma"
    base = r.float() if site == "o" else 0.0
    assert _rel(got.float() - base, want.float() - base) < 2e-2
    assert _rel(got.float() - base, chain.float() - base) < 2e-2
    assert _same_bits(got, call())


def test_k1_options_raise_on_what_they_do_not_take(cuda):
    qt, x, nw, r, meta = _k1_option_inputs(_gen(), cuda, 4, 32, False, 33)
    with pytest.raises(ValueError):  # over 8 rows at a group the Hopper route does not take
        k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, norm_w=nw)
    qt, x, nw, r, meta = _k1_option_inputs(_gen(), cuda, 4, 64, False, 33, N=392)
    with pytest.raises(ValueError):  # over 8 rows at N % 16 != 0
        k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, resid=r)
    qt, x, nw, r, meta = _k1_option_inputs(_gen(), cuda, 4, 64, False, 8, N=386)
    with pytest.raises(ValueError):  # N % 4 != 0
        k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, resid=r)
    qt, x, nw, r, meta = _k1_option_inputs(_gen(), cuda, 4, 64, False, 8)
    with pytest.raises(ValueError):  # a residual of another shape
        k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, resid=r[:, :128])


def _k13_inputs(g, dev, bits, group, M, D=256, F=512, Q=256, Nq=512, L=2):
    from qtpu_torch.core.packing import quantize_pack as qp

    shapes = ((Q, D), (D, 2 * F), (F, D), (D, Nq))

    def site(K, N):
        parts = [qp(torch.randn(K, N, generator=g, device=dev) * 0.05, bits, group)
                 for _ in range(L)]
        return {k: torch.stack([getattr(p, k) for p in parts]) for k in ("data", "scales", "zeros")}

    sites = [site(K, N) for K, N in shapes]
    metas = tuple((bits, group, K, N) for K, N in shapes)
    attn = torch.randn(M, Q, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(M, D, generator=g, device=dev).to(torch.bfloat16)
    norms = (1.0 + 0.1 * torch.randn(2, L, D, generator=g, device=dev)).to(torch.bfloat16)
    views = [{k: v[0] for k, v in s.items()} for s in sites[:3]] + [
        {k: v[1] for k, v in sites[3].items()}]
    return (attn, x, norms[0][0], norms[1][1], *views, metas)


@pytest.mark.parametrize("bits,group", [(4, 128), (4, 64), (8, 128)])
@pytest.mark.parametrize("M", [1, 3, 8, 17, 32])
def test_k13_matches_plain(cuda, bits, group, M):
    """K13 against its plain version (layer 0's o/gateup/down, layer 1's
    qkv): relative 2e-2 on y2 - x and on qkv; one launch."""
    from qtpu_torch.kernels import layer_boundary as k13

    args = _k13_inputs(_gen(), cuda, bits, group, M)
    n0 = k13.layer_boundary.launches
    y2, qkv = k13.layer_boundary(*args)
    want_y2, want_qkv = k13.layer_boundary_plain(*args)
    torch.cuda.synchronize()
    assert k13.layer_boundary.launches == n0 + 1
    x = args[1].float()
    assert _rel(y2.float() - x, want_y2.float() - x) < 2e-2
    assert _rel(qkv, want_qkv) < 2e-2


def test_k13_is_deterministic_and_runs_in_a_cuda_graph(cuda):
    """Partial sums are reduced in a fixed order: two calls give the same
    bits; the cooperative launch replays from a captured CUDA graph."""
    from qtpu_torch.kernels import layer_boundary as k13

    args = _k13_inputs(_gen(), cuda, 4, 128, 8)
    a, b = k13.layer_boundary(*args), k13.layer_boundary(*args)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k13.layer_boundary(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k13.layer_boundary(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(out, a))


def test_k13_raises_on_what_it_does_not_take(cuda):
    from qtpu_torch.kernels import layer_boundary as k13

    args = _k13_inputs(_gen(), cuda, 4, 128, 33)
    with pytest.raises(ValueError):  # over 32 rows
        k13.layer_boundary(*args)
    args = list(_k13_inputs(_gen(), cuda, 4, 128, 8))
    args[4] = {**args[4], "zeros": None}  # symmetric o_proj
    with pytest.raises(ValueError):
        k13.layer_boundary(*args)
    metas = args[-1]
    args[4] = _k13_inputs(_gen(), cuda, 4, 128, 8)[4]
    args[-1] = (metas[0], metas[1], (8,) + metas[2][1:], metas[3])  # mixed bits
    with pytest.raises(ValueError):
        k13.layer_boundary(*args)


@pytest.mark.parametrize("switch", ["QTPU_FUSE_NORM_RESID", "QTPU_BOUNDARY"])
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_branch_decode_on_card_matches_cpu(cuda, switch, kv, monkeypatch):
    """TINY_TEST RTN W4 g64 fused under one of qtpu's decode-branch switches:
    prefill and 3 teacher-forced decode steps on the card (fuse: K1 with
    norm_w and resid once a layer each; boundary: K1 with norm_w once, K13
    once a layer) against the CPU, which takes the same branch on the plain
    versions."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.kernels import layer_boundary as k13
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINY_TEST as cfg
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    monkeypatch.setenv(switch, "1")
    params, qmeta = fuse_packed_sites(*pack_model(llama.init_params(cfg, device="cpu"), "rtn",
                                                  {"w_bit": 4, "q_group_size": 64}))
    B, T = 4, 12
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=torch.Generator().manual_seed(2))
    outs, L = {}, cfg.num_layers
    for dev in ("cpu", "cuda"):
        p = map_tree(params, lambda t: t.to(dev))
        cache = init_cache(cfg, B, 24, quantized=kv == "int8", device=dev)
        logits, cache = prefill(p, ids.to(dev), cache, cfg, qmeta)
        res, pos = [logits.float().cpu()], torch.full((B,), T, dtype=torch.int32, device=dev)
        n0 = (k13.layer_boundary.launches, k1.quantized_matmul.norm_launches,
              k1.quantized_matmul.resid_launches)
        for i in range(3):
            logits, cache = decode_step(p, ids[:, i].to(torch.int32).to(dev), pos, cache, cfg,
                                        qmeta)
            res.append(logits.float().cpu())
            pos = pos + 1
        if dev == "cuda":
            got = (k13.layer_boundary.launches - n0[0], k1.quantized_matmul.norm_launches - n0[1],
                   k1.quantized_matmul.resid_launches - n0[2])
            assert got == ((3 * L, 3, 0) if switch == "QTPU_BOUNDARY" else (0, 3 * L, 3 * L))
        outs[dev] = res
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert _rel(a, b) < 3e-2


# K9 and K6 at M > 8 on the Hopper route: K9 with the expert axis of
# csrc/dq_wgmma.cuh, K6 on int8 wgmma fed by TMA (csrc/w8a8_matmul.cu)
@pytest.mark.parametrize("M", [9, 77, 300, 1024])
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("bits,group,sym", [(4, 128, False), (4, 64, True), (8, 128, False),
                                            (2, 64, False)])
def test_k9_hopper_route_matches_plain(cuda, M, per_expert, bits, group, sym):
    """K9 on the route (E 4 experts of a layer view W[1] of an [L, E, ...]
    leaf) within 2e-2 of its plain version, the route its counters saw equal
    to moe_route's rule, two calls the same bits, and near the mma.sync body
    on the same bytes (both sum each group in f32, in other orders)."""
    g = _gen()
    E, L, K, N = 4, 3, 512, 384
    data, scales, zeros = _experts(g, E, K, N, bits, group, cuda, sym, L=L)
    x = torch.randn(*((E,) if per_expert else ()), M, K, generator=g, device=cuda)
    x = x.to(torch.bfloat16)
    meta = (bits, group, K, N)
    z = None if zeros is None else zeros[1]
    got, route = _route_and_out(
        k9.moe_matmul, lambda: k9.moe_matmul(x, data[1], scales[1], z, meta,
                                             per_expert_input=per_expert))
    want = k9.moe_matmul_plain(x, data[1], scales[1], z, meta, per_expert_input=per_expert)
    body = k9.moe_matmul_mma(x, data[1], scales[1], z, meta, per_expert_input=per_expert)
    torch.cuda.synchronize()
    ptrs = [t.data_ptr() for t in (data[1], scales[1], z) if t is not None]
    assert route == k9.moe_route(M, K, N, bits, group, ptrs, per_expert) == "wgmma"
    assert _rel(got, want) < 2e-2
    assert _rel(got, body) < 2e-3
    assert _same_bits(got, k9.moe_matmul(x, data[1], scales[1], z, meta,
                                         per_expert_input=per_expert))


@pytest.mark.parametrize("M", [9, 77, 300, 1024, 2048])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (5632, 2048), (2048, 5632),
                                 (1000, 384), (64, 128)])
def test_k6_hopper_route_bits_equal_mma_body(cuda, M, K, N):
    """K6 on the route within 2e-2 of its plain version, the route its
    counters saw equal to w8a8_route's rule, and the same bits as the
    mma.sync body on the same bytes: the int32 sums are exact and the
    epilogue's float order is the body's. Ragged K (1000; 64) runs on the
    zeros TMA fills past K and Kp."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    data, scales, zeros, meta = _w8_site(g, K, N, cuda)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    x[0] = 0  # an all-zero token: the 1e-8 floor of sx
    got, route = _route_and_out(k6.w8a8_matmul,
                                lambda: k6.w8a8_matmul(x, data, scales, zeros, meta))
    want = k6.w8a8_matmul_plain(x, data, scales, zeros, meta)
    body = k6.w8a8_matmul_mma(x, data, scales, zeros, meta)
    torch.cuda.synchronize()
    assert route == k6.w8a8_route(M, N, (data.data_ptr(), scales.data_ptr())) == "wgmma"
    assert _k6_err(got, want) < 2e-2 and _rel(got, want) < 2e-2
    assert _same_bits(got, body)
    assert _same_bits(got, k6.w8a8_matmul(x, data, scales, zeros, meta))


def test_k9_k6_hopper_routes_replay_in_a_cuda_graph(cuda):
    """K9 and K6 on the Hopper route captured in a CUDA graph (the tensor
    maps are encoded at capture and live in the launch's parameters) give
    the eager call's bits on replay."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    E, K, N, M = 4, 1024, 512, 300
    data, scales, zeros = _experts(g, E, K, N, 4, 128, cuda)
    d8, s8, z8, m8 = _w8_site(g, K, N, cuda)
    x = torch.randn(E, M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (4, 128, K, N)

    def calls():
        return (k9.moe_matmul(x, data, scales, zeros, meta, per_expert_input=True),
                k6.w8a8_matmul(x[0], d8, s8, z8, m8))

    eager = calls()
    w9, w6 = k9.moe_matmul.wgmma_launches, k6.w8a8_matmul.wgmma_launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm on a side stream before capture
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y9, y6 = calls()
    y9.zero_()
    y6.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert k9.moe_matmul.wgmma_launches == w9 + 2
    assert k6.w8a8_matmul.wgmma_launches == w6 + 2
    assert _same_bits(y9, eager[0]) and _same_bits(y6, eager[1])


# ------------------------------------------- the tensor-core decode GEMV (dq_gemv_tc.cuh)

GEMV_TC_PACKINGS = [(4, 128, False), (4, 64, True), (8, 128, False), (8, 64, True)]


@pytest.mark.parametrize("M", [1, 3, 5, 8])
@pytest.mark.parametrize("bits,group,sym", GEMV_TC_PACKINGS)
@pytest.mark.parametrize("K,N", [(512, 384), (2048, 2560), (5632, 2048), (768, 50272)])
def test_gemv_tc_k1_matches_plain_and_the_earlier_body(cuda, M, bits, group, sym, K, N):
    """K1 at M <= 8 on the tensor-core GEMV (route counter, then the plain
    version within K1's tolerance, the earlier body's f32 arithmetic closer
    still, and the same bits call after call)."""
    g = _gen()
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, bits, group, sym)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (bits, group, K, N)
    call = lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta)  # noqa: E731
    got, route = _route_and_out(k1.quantized_matmul, call)
    assert route == "gemv_tc"
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta)
    was = k1.quantized_matmul_simt(x, qt.data, qt.scales, qt.zeros, meta)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2
    assert _rel(got, was) < 5e-3
    assert _same_bits(got, call())


@pytest.mark.parametrize("option", ["norm_w", "resid", "both"])
@pytest.mark.parametrize("bits,group,sym", GEMV_TC_PACKINGS)
@pytest.mark.parametrize("M", [1, 8])
def test_gemv_tc_k1_options_match_plain(cuda, option, bits, group, sym, M):
    """K1's norm_w / resid (MODE 4, 2, 6) on the tensor-core GEMV."""
    qt, x, nw, resid, meta = _k1_option_inputs(_gen(), cuda, bits, group, sym, M)
    kw = {"norm_w": nw if option != "resid" else None,
          "resid": resid if option != "norm_w" else None}
    got, route = _route_and_out(
        k1.quantized_matmul, lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, meta, **kw))
    want = k1.quantized_matmul_plain(x, qt.data, qt.scales, qt.zeros, meta, **kw)
    was = k1.quantized_matmul_simt(x, qt.data, qt.scales, qt.zeros, meta, **kw)
    torch.cuda.synchronize()
    assert route == "gemv_tc"
    assert _rel(got, want) < 2e-2 and _rel(got, was) < 5e-3


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("apot", [False, True])
@pytest.mark.parametrize("K,N", [(512, 384), (2048, 11264)])
def test_gemv_tc_k7_matches_plain(cuda, M, group, apot, K, N):
    """K7's codebook mode (MODE 3) on the tensor-core GEMV: the Pallas
    kernel's tolerance (relative 2e-2, atol 5% of max)."""
    from qtpu_torch.kernels import codebook_matmul as k7

    g = _gen()
    data, sc, cb = _pot_site(g, K, N, group, cuda, apot)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    meta = (4, group, K, N)
    got, route = _route_and_out(k7.codebook_matmul,
                                lambda: k7.codebook_matmul(x, data, sc, cb, meta))
    want = k7.codebook_matmul_plain(x, data, sc, cb, meta)
    torch.cuda.synchronize()
    assert route == "gemv_tc"
    assert _rel(got, want) < 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=0.05 * float(want.float().abs().max()))
    assert _same_bits(got, k7.codebook_matmul(x, data, sc, cb, meta))


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("per_expert", [False, True])
@pytest.mark.parametrize("bits,group,sym", GEMV_TC_PACKINGS)
@pytest.mark.parametrize("E,K,N", [(3, 512, 384), (8, 1024, 2048)])
def test_gemv_tc_k9_matches_plain(cuda, M, per_expert, bits, group, sym, E, K, N):
    """K9 at decode rows on the tensor-core GEMV with its expert axis."""
    g = _gen()
    data, scales, zeros = _experts(g, E, K, N, bits, group, cuda, sym)
    x = torch.randn(*((E,) if per_expert else ()), M, K, generator=g, device=cuda)
    x = x.to(torch.bfloat16)
    meta = (bits, group, K, N)
    call = lambda: k9.moe_matmul(x, data, scales, zeros, meta, per_expert)  # noqa: E731
    got, route = _route_and_out(k9.moe_matmul, call)
    want = k9.moe_matmul_plain(x, data, scales, zeros, meta, per_expert)
    was = k9.moe_matmul_simt(x, data, scales, zeros, meta, per_expert)
    torch.cuda.synchronize()
    assert route == "gemv_tc"
    assert _rel(got, want) < 2e-2 and _rel(got, was) < 5e-3
    assert _same_bits(got, call())


@pytest.mark.parametrize("bits,group", [(4, 128), (4, 64), (8, 128), (8, 64)])
@pytest.mark.parametrize("M", [1, 5, 8])
@pytest.mark.parametrize("D,F", [(512, 1024), (2048, 5632)])
def test_gemv_tc_k4_matches_plain(cuda, bits, group, M, D, F):
    """K4's two phases (MODE 1: norm prologue and the SwiGLU pair; MODE 2:
    the residual) on the tensor-core GEMV."""
    g = _gen()
    gu = quantize_pack(torch.randn(D, 2 * F, generator=g, device=cuda) * 0.05, bits, group)
    dn = quantize_pack(torch.randn(F, D, generator=g, device=cuda) * 0.05, bits, group)
    nw = (1.0 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(torch.bfloat16)
    x = torch.randn(M, 1, D, generator=g, device=cuda).to(torch.bfloat16)
    args = (x, nw, gu.data, gu.scales, gu.zeros, dn.data, dn.scales, dn.zeros,
            (bits, group, D, 2 * F), (bits, group, F, D))
    t0 = k4.fused_mlp.gemv_tc_launches
    got, want, was = k4.fused_mlp(*args), k4.fused_mlp_plain(*args), k4.fused_mlp_simt(*args)
    torch.cuda.synchronize()
    assert k4.fused_mlp.gemv_tc_launches == t0 + 1
    assert _rel(got - x, want - x) < 3e-2
    assert _rel(got - x, was - x) < 5e-3


def test_gemv_tc_replays_in_a_cuda_graph_without_a_host_sync(cuda):
    """K1, K7, K9 and K4 on the tensor-core GEMV captured in a CUDA graph
    give the eager bits on replay, and make no host sync."""
    from qtpu_torch.kernels import codebook_matmul as k7

    g = _gen()
    K, N, F = 1024, 2048, 1024
    qt = quantize_pack(torch.randn(K, N, generator=g, device=cuda) * 0.02, 4, 128)
    data, sc, cb = _pot_site(g, K, N, 128, cuda)
    ex = _experts(g, 4, K, N, 4, 128, cuda)
    gu = quantize_pack(torch.randn(K, 2 * F, generator=g, device=cuda) * 0.05, 4, 128)
    dn = quantize_pack(torch.randn(F, K, generator=g, device=cuda) * 0.05, 4, 128)
    nw = torch.ones(K, dtype=torch.bfloat16, device=cuda)
    x = torch.randn(8, K, generator=g, device=cuda).to(torch.bfloat16)
    m = (4, 128, K, N)
    calls = [lambda: k1.quantized_matmul(x, qt.data, qt.scales, qt.zeros, m),
             lambda: k7.codebook_matmul(x, data, sc, cb, m),
             lambda: k9.moe_matmul(x, *ex, m),
             lambda: k4.fused_mlp(x[:, None], nw, gu.data, gu.scales, gu.zeros, dn.data,
                                  dn.scales, dn.zeros, (4, 128, K, 2 * F), (4, 128, F, K))]
    eager = [c() for c in calls]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for c in calls:
                c()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [c() for c in calls]
        for o in outs:
            o.zero_()
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(_same_bits(a, b) for a, b in zip(outs, eager))


# ------------------------------------------------------------ K5's Hopper body

@pytest.mark.parametrize("window", [0, 4096, 300])
@pytest.mark.parametrize("S", [2048, 1000, 4100])
@pytest.mark.parametrize("hd,H,KV", [(64, 32, 4), (128, 32, 8), (64, 12, 12), (80, 32, 32),
                                     (96, 32, 8), (48, 16, 4), (112, 16, 2), (32, 16, 16),
                                     (256, 12, 4), (40, 16, 4), (136, 8, 2), (64, 48, 1)])
def test_k5_hopper_body_matches_plain_and_the_mma_body(cuda, window, S, hd, H, KV):
    """K5 on wgmma fed by TMA at the eval widths (TinyLlama, Mistral-7B
    with its 4096 window, GPT-2, OPT-2.7B at hd 80, and the other head dims
    it takes in the tile of the next multiple of 64), ragged S: the route
    counter, the plain
    version (relative 2e-2) and the f32 math (rtol/atol 2e-2, the Pallas
    kernel's test), and the mma.sync body within 1e-2."""
    from qtpu_torch.kernels import flash_attention as k5

    q, k, v = _bf16_qkv(_gen(), 1, H, KV, S, hd, cuda)
    w0 = k5.flash_attention.wgmma_launches
    got = k5.flash_attention(q, k, v, window)
    assert k5.flash_attention.wgmma_launches == w0 + 1
    want = k5.flash_attention_plain(q, k, v, window)
    was = k5.flash_attention_mma(q, k, v, window)
    torch.cuda.synchronize()
    assert _rel(got, want) < 2e-2 and _rel(got, was) < 1e-2
    want32 = k5.flash_attention_plain(q.float(), k.float(), v.float(), window)
    torch.testing.assert_close(got.float(), want32, rtol=2e-2, atol=2e-2)
    assert _same_bits(got, k5.flash_attention(q, k, v, window))


def test_k5_routes_and_their_counters(cuda):
    """A q the Hopper body does not take (4-byte aligned) runs the mma.sync
    body and counts it; its launches are the kernel each counter names."""
    from qtpu_torch.kernels import flash_attention as k5

    g = _gen()
    q, k, v = _bf16_qkv(g, 1, 8, 2, 300, 64, cuda)
    buf = torch.empty(q.numel() + 2, dtype=torch.bfloat16, device=cuda)
    qm = buf[2:].view(q.shape)  # 4-byte aligned, not 16
    qm.copy_(q)
    assert k5.flash_route(64, [t.data_ptr() for t in (qm, k, v)],
                          [s for t in (qm, k, v) for s in t.stride()[:3]]) == "mma"
    for qq, route, kernel in ((q, "wgmma", "flash_wgmma_kernel"), (qm, "mma", "flash_attn_kernel")):
        k5.flash_attention(qq, k, v)
        torch.cuda.synchronize()
        c0, n0 = getattr(k5.flash_attention, f"{route}_launches"), k5.flash_attention.launches
        seen = _graph_kernels(lambda qq=qq: k5.flash_attention(qq, k, v), 4)
        calls = k5.flash_attention.launches - n0
        assert calls >= 4 and getattr(k5.flash_attention, f"{route}_launches") == c0 + calls
        names = [n for n in seen if "flash" in n]
        assert names and all(kernel in n for n in names), seen
        out = k5.flash_attention(qq, k, v)
        assert _rel(out, k5.flash_attention_plain(q, k, v)) < 2e-2


def test_k5_hopper_body_replays_in_a_cuda_graph_without_a_host_sync(cuda):
    from qtpu_torch.kernels import flash_attention as k5

    q, k, v = _bf16_qkv(_gen(), 2, 8, 2, 700, 128, cuda)
    eager = k5.flash_attention(q, k, v, 256)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k5.flash_attention(q, k, v, 256)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = k5.flash_attention(q, k, v, 256)
        out.zero_()
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _same_bits(out, eager)


# --------------------- K6's decode GEMV and K13's phases on the tensor cores

# (K, N) of TinyLlama-1.1B's W8A8 sites (unfused: q/o, k/v, gate/up, down, lm_head)
K6_SITES = {"q_o": (2048, 2048), "k_v": (2048, 256), "gate_up": (2048, 5632),
            "down": (5632, 2048), "lm_head": (2048, 32000)}


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("site", sorted(K6_SITES))
def test_k6_gemv_tc_bits_equal_the_dp4a_body(cuda, M, site):
    """K6 at M <= 8 on the tensor-core GEMV (one launch, x quantized
    inside, K split over a cluster) at every TinyLlama W8A8 site: the route
    its counters saw is w8a8_gemv_route's, within 2e-2 of the plain version,
    and the same bits as the dp4a body on the same bytes (the int32 sums are
    exact and the epilogue's float order is the body's) and as a second
    call."""
    from qtpu_torch.kernels import int8_matmul as k6

    K, N = K6_SITES[site]
    g = _gen()
    data, scales, zeros, meta = _w8_site(g, K, N, cuda)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    x[-1] = 0  # an all-zero token: the 1e-8 floor of sx
    got, route = _route_and_out(k6.w8a8_matmul,
                                lambda: k6.w8a8_matmul(x, data, scales, zeros, meta))
    assert route == k6.w8a8_gemv_route(M, K, N, (x.data_ptr(), data.data_ptr())) == "gemv_tc"
    want = k6.w8a8_matmul_plain(x, data, scales, zeros, meta)
    was = k6.w8a8_matmul_dp4a(x, data, scales, zeros, meta)
    torch.cuda.synchronize()
    assert _k6_err(got, want) < 2e-2 and _rel(got, want) < 2e-2
    assert _same_bits(got, was)
    assert _same_bits(got, k6.w8a8_matmul(x, data, scales, zeros, meta))
    assert not bool(got[-1].any())


# K6's two modes at TinyLlama's TP 2 row-parallel shapes (a rank's K slice):
# o_proj K 1024, down_proj K 2816, N 2048
K6_TP2_SITES = {"o": (1024, 2048), "down": (2816, 2048)}


@pytest.mark.parametrize("M", [1, 8, 32, 1024])
@pytest.mark.parametrize("site", sorted(K6_TP2_SITES))
def test_k6_absmax_modes(cuda, M, site):
    """absmax out equals the plain absmax bit for bit (a max is order-free);
    absmax in (a TP rank's int32 sums) with the row's own absmax gives the
    plain version's sums on the route w8a8_matmul takes and on the earlier
    body (dp4a at M <= 8, mma.sync above), counted by mode and route, and
    their rescale (w8a8_epilogue) the usual mode's bits and its plain
    version's; with a foreign absmax (twice the own one) the sums are the
    plain version's and the rescale stays within K6's band of it."""
    from qtpu_torch.kernels import int8_matmul as k6

    K, N = K6_TP2_SITES[site]
    g = _gen()
    data, scales, zeros, meta = _w8_site(g, K, N, cuda)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    x[-1] = 0
    a0, i0 = k6.w8a8_absmax.launches, k6.w8a8_matmul.absmax_in_launches
    amax = k6.w8a8_absmax(x)
    torch.cuda.synchronize()
    assert k6.w8a8_absmax.launches == a0 + 1
    assert torch.equal(amax, k6.absmax_plain(x))
    usual = k6.w8a8_matmul(x, data, scales, zeros, meta)
    route = ("gemv_tc" if M <= 8 else
             k6.w8a8_route(M, N, (data.data_ptr(), scales.data_ptr())))
    r0 = getattr(k6.w8a8_matmul, f"absmax_in_{route}_launches")
    e0 = k6.w8a8_epilogue.launches
    total = k6.w8a8_matmul(x, data, scales, zeros, meta, absmax=amax)
    earlier = (k6.w8a8_matmul_dp4a if M <= 8 else k6.w8a8_matmul_mma)
    total_was = earlier(x, data, scales, zeros, meta, absmax=amax)
    y = k6.w8a8_epilogue(total, amax, scales)
    torch.cuda.synchronize()
    assert k6.w8a8_matmul.absmax_in_launches == i0 + 1
    assert getattr(k6.w8a8_matmul, f"absmax_in_{route}_launches") == r0 + 1
    assert k6.w8a8_epilogue.launches == e0 + 1 and total.dtype == torch.int32
    assert torch.equal(total, total_was)
    assert torch.equal(total, k6.w8a8_matmul_plain(x, data, scales, zeros, meta, absmax=amax))
    assert _same_bits(y, usual)
    assert _same_bits(y, k6.w8a8_epilogue_plain(total, amax, scales))
    foreign = amax * 2
    got_total = k6.w8a8_matmul(x, data, scales, zeros, meta, absmax=foreign)
    want_total = k6.w8a8_matmul_plain(x, data, scales, zeros, meta, absmax=foreign)
    got = k6.w8a8_epilogue(got_total, foreign, scales)
    want = k6.w8a8_epilogue_plain(want_total, foreign, scales)
    torch.cuda.synchronize()
    assert torch.equal(got_total, want_total)
    assert _k6_err(got, want) < 2e-2 and _rel(got, want) < 2e-2


def test_k6_gemv_tc_on_layer_views_and_row_views(cuda):
    """Layer views W[l] of stacked [L, K, N] weights and x as rows of a
    larger batch take the tensor-core GEMV; an x 8 bytes off a 16-byte unit
    keeps the dp4a body; both give the dp4a body's bits."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    K, N = 2048, 2048
    sites = [_w8_site(g, K, N, cuda) for _ in range(3)]
    data, scales, zeros = (torch.stack([s[i] for s in sites]) for i in range(3))
    meta = sites[0][3]
    xs = (torch.randn(4, 3, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    flat = torch.empty(6 * K + 4, dtype=torch.bfloat16, device=cuda)
    flat[4:].copy_(xs[:2].reshape(-1))
    for layer in (1, 2):
        d, s_, z = data[layer], scales[layer], zeros[layer]
        for x, route in ((xs[1:3], "gemv_tc"), (flat[4:].view(2, 3, K), "gemv")):
            got, seen = _route_and_out(k6.w8a8_matmul, lambda: k6.w8a8_matmul(x, d, s_, z, meta))
            assert seen == route == k6.w8a8_gemv_route(6, K, N, (x.data_ptr(), d.data_ptr()))
            was = k6.w8a8_matmul_dp4a(x, d, s_, z, meta)
            torch.cuda.synchronize()
            assert got.shape == (2, 3, N) and _same_bits(got, was)
            assert _k6_err(got, k6.w8a8_matmul_plain(x, d, s_, z, meta)) < 2e-2


@pytest.mark.parametrize("K,N,M", [(768, 2304, 8), (3072, 768, 5), (768, 50272, 2),
                                   (11008, 4096, 8), (14336, 4096, 1), (96, 48, 7)])
def test_k6_gemv_tc_at_other_widths(cuda, K, N, M):
    """GPT-2/OPT's and Llama-2-7B's/Mistral-7B's widths (clusters 1 to 8,
    slices of 96 to 1792 rows, OPT's lm_head a ragged last strip) and a
    tiny site: the dp4a body's bits."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    data, scales, zeros, meta = _w8_site(g, K, N, cuda)
    x = (torch.randn(M, K, generator=g, device=cuda) * 2).to(torch.bfloat16)
    got, route = _route_and_out(k6.w8a8_matmul,
                                lambda: k6.w8a8_matmul(x, data, scales, zeros, meta))
    was = k6.w8a8_matmul_dp4a(x, data, scales, zeros, meta)
    torch.cuda.synchronize()
    assert route == "gemv_tc" and _same_bits(got, was)


def test_k6_gemv_tc_replays_in_a_cuda_graph_without_a_host_sync(cuda):
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    d, s_, z, meta = _w8_site(g, 2048, 5632, cuda)
    x = (torch.randn(8, 2048, generator=g, device=cuda) * 2).to(torch.bfloat16)
    eager = k6.w8a8_matmul(x, d, s_, z, meta)
    t0 = k6.w8a8_matmul.gemv_tc_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            k6.w8a8_matmul(x, d, s_, z, meta)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = k6.w8a8_matmul(x, d, s_, z, meta)
        out.zero_()
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert k6.w8a8_matmul.gemv_tc_launches == t0 + 2
    assert _same_bits(out, eager)


def test_k6_gemv_tc_is_one_cuda_launch(cuda):
    """A graph of 4 calls holds one kernel a call on the tensor-core
    GEMV (no quantization or finishing launch), three on the dp4a body."""
    from qtpu_torch.kernels import int8_matmul as k6

    g = _gen()
    d, s_, z, meta = _w8_site(g, 2048, 2048, cuda)
    x = (torch.randn(8, 2048, generator=g, device=cuda) * 2).to(torch.bfloat16)
    for wrapper, kernels in ((k6.w8a8_matmul, {"w8a8_gemv_tc_kernel"}),
                             (k6.w8a8_matmul_dp4a, {"w8a8_quant_kernel", "w8a8_gemv_kernel",
                                                    "w8a8_finish_kernel"})):
        wrapper(x, d, s_, z, meta)
        torch.cuda.synchronize()
        seen = _graph_kernels(lambda wrapper=wrapper: wrapper(x, d, s_, z, meta), 4)
        seen = {n: c for n, c in seen.items() if "w8a8" in n}
        assert {next(k for k in kernels if k + "(" in n or k + "<" in n) for n in seen} == kernels
        assert all(c == 4 for c in seen.values()), seen


@pytest.mark.parametrize("bits,group", [(4, 128), (4, 64), (8, 128), (8, 64)])
@pytest.mark.parametrize("M", [1, 3, 8, 17, 32])
def test_k13_tc_phases_match_plain_and_the_dq_body(cuda, bits, group, M):
    """K13's matmul phases on the tensor-core step (the route its counters
    saw is boundary_route's): within 2e-2 of the plain version and of the
    dq_core tiles on the same bytes (relative, on y2 - x and on qkv), and
    two calls give the same bits."""
    from qtpu_torch.kernels import layer_boundary as k13

    args = _k13_inputs(_gen(), cuda, bits, group, M)
    ptrs = [args[0].data_ptr()] + [s[k].data_ptr() for s in args[4:8]
                                   for k in ("data", "scales", "zeros")]
    assert k13.boundary_route(args[-1], ptrs) == "gemv_tc"
    t0 = k13.layer_boundary.gemv_tc_launches
    y2, qkv = k13.layer_boundary(*args)
    assert k13.layer_boundary.gemv_tc_launches == t0 + 1
    want_y2, want_qkv = k13.layer_boundary_plain(*args)
    was_y2, was_qkv = k13.layer_boundary_dq(*args)
    torch.cuda.synchronize()
    x = args[1].float()
    for ref_y2, ref_qkv in ((want_y2, want_qkv), (was_y2, was_qkv)):
        assert _rel(y2.float() - x, ref_y2.float() - x) < 2e-2
        assert _rel(qkv, ref_qkv) < 2e-2
    again = k13.layer_boundary(*args)
    assert _same_bits(y2, again[0]) and _same_bits(qkv, again[1])


@pytest.mark.parametrize("M", [1, 8, 32])
def test_k13_tc_phases_at_tinyllama_width(cuda, M):
    """One TinyLlama-1.1B layer (D 2048, F 5632, qkv 2560), W4 g128: the
    tensor-core phases within 2e-2 of the plain version and of the dq_core
    tiles."""
    from qtpu_torch.kernels import layer_boundary as k13

    args = _k13_inputs(_gen(), cuda, 4, 128, M, D=2048, F=5632, Q=2048, Nq=2560)
    t0 = k13.layer_boundary.gemv_tc_launches
    y2, qkv = k13.layer_boundary(*args)
    want = k13.layer_boundary_plain(*args)
    was = k13.layer_boundary_dq(*args)
    torch.cuda.synchronize()
    assert k13.layer_boundary.gemv_tc_launches == t0 + 1
    x = args[1].float()
    for ref in (want, was):
        assert _rel(y2.float() - x, ref[0].float() - x) < 2e-2 and _rel(qkv, ref[1]) < 2e-2


def test_k13_route_counters_name_the_tiles_that_ran(cuda):
    """An attn 8 bytes off a 16-byte unit keeps the dq_core tiles (and
    counts them); a graph of 4 calls holds one boundary_kernel a call, of the
    build each counter names."""
    from qtpu_torch.kernels import layer_boundary as k13

    args = list(_k13_inputs(_gen(), cuda, 4, 128, 8))
    buf = torch.empty(args[0].numel() + 4, dtype=torch.bfloat16, device=cuda)
    shifted = buf[4:].view(args[0].shape)
    shifted.copy_(args[0])
    want = k13.layer_boundary_plain(*args)
    for attn, route, build in ((args[0], "gemv_tc", "true"), (shifted, "gemv", "false")):
        call = [attn] + args[1:]
        k13.layer_boundary(*call)
        torch.cuda.synchronize()
        c0, n0 = getattr(k13.layer_boundary, f"{route}_launches"), k13.layer_boundary.launches
        seen = _graph_kernels(lambda call=call: k13.layer_boundary(*call), 4)
        calls = k13.layer_boundary.launches - n0
        assert getattr(k13.layer_boundary, f"{route}_launches") == c0 + calls
        names = {n: c for n, c in seen.items() if "boundary_kernel" in n}
        assert names and all(f",{build}>" in n.replace(" ", "") for n in names), seen
        assert sum(names.values()) == 4, names
        out = k13.layer_boundary(*call)
        x = args[1].float()
        assert _rel(out[0].float() - x, want[0].float() - x) < 2e-2
        assert _rel(out[1], want[1]) < 2e-2


# ---------------------------------------------------------------- the engine's CUDA graphs

ENGINE_WORK = [(9, 40), (20, 12), (33, 70)]  # (prompt length, max_new_tokens): drain blocks too


def _engine_model(width):
    """RTN W4 fused on the card: TINY_TEST (g64), or 2 layers at TinyLlama-1.1B's
    widths (g128)."""
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINY_TEST, TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    cfg = TINY_TEST if width == "tiny" else TINYLLAMA_1_1B.replace(num_layers=2)
    params = llama.init_params(cfg, seed=0, device="cuda")
    group = 64 if width == "tiny" else 128
    return (*fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4, "q_group_size": group})),
            cfg)


def _engine(model, kv, graphs, seed=0, max_batch=4):
    from qtpu_torch.serve.batching import ContinuousBatcher

    params, qmeta, cfg = model
    per_layer = kv == "int8_per_layer"
    # per-layer: S = 2040 + 8 = 2048, so its int8 decode runs K12
    return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=max_batch,
                             max_seq_len=2040 if per_layer else 128,
                             kv_dtype="bfloat16" if kv == "bfloat16" else "int8", decode_block=8,
                             kv_layout="per_layer" if per_layer else None, seed=seed,
                             device="cuda", cuda_graphs=graphs)


def _served(eng, cfg):
    """The engine's greedy outputs on ENGINE_WORK and the counter deltas
    (every launch and route counter of the kernel wrappers) of the run."""
    import numpy as np

    from qtpu_torch.serve.graphs import counter_cells, counter_snapshot

    rng = np.random.default_rng(5)
    before = counter_snapshot()
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=m) for n, m in ENGINE_WORK]
    eng.run()
    torch.cuda.synchronize()
    delta = {f"{w.__name__}.{a}": b - a0 for (w, a), a0, b
             in zip(counter_cells(), before, counter_snapshot()) if b != a0}
    assert all(r.done and len(r.output) == m for r, (_, m) in zip(reqs, ENGINE_WORK))
    return [r.output for r in reqs], delta


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "int8_per_layer"])
@pytest.mark.parametrize("width", ["tiny", "tinyllama2"])
def test_graph_and_eager_engines_agree(cuda, width, kv):
    """The same requests (decode blocks of 8, and drain blocks of 32 and 64)
    on an engine that replays captured CUDA graphs and on an eager one:
    the same greedy tokens, and the same launch and route counts."""
    model = _engine_model(width)
    eager = _engine(model, kv, graphs=False)
    graph = _engine(model, kv, graphs=True)
    assert graph.warmup() > 0.0 and eager.warmup() > 0.0
    assert set(graph.graphs) == {(8, False), (32, False), (64, False)} and not eager.graphs
    want, want_n = _served(eager, model[2])
    got, got_n = _served(graph, model[2])
    assert got == want
    assert got_n == want_n and got_n
    assert graph.decode_steps == eager.decode_steps
    attention = {"int8": "cache_band_write.launches", "bfloat16":
                 "decode_attention_write_bf16.launches",
                 "int8_per_layer": "decode_attention_flash.launches"}[kv]
    L = model[2].num_layers
    assert got_n[attention] == L * graph.decode_steps


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "int8_per_layer"])
def test_warmup_leaves_the_cache_and_generator_as_they_were(cuda, kv):
    import numpy as np

    model = _engine_model("tiny")
    eng = _engine(model, kv, graphs=True)
    eng.submit(np.arange(13), max_new_tokens=4)
    eng.step()  # the prefill: the live cache holds rows
    c = eng.cache
    stores = lambda: [t.clone() for f in (c.k, c.v, c.k_scale, c.v_scale, (c.length,))
                      if f is not None for t in (f if isinstance(f, tuple) else (f,))]
    before, state = stores(), eng.generator.get_state()
    eng.warmup(include_sampling=True)
    torch.cuda.synchronize()
    assert len(eng.graphs) == 6
    assert all(torch.equal(a, b) for a, b in zip(before, stores()))
    assert torch.equal(state, eng.generator.get_state())


def test_a_decode_block_replays_without_a_host_sync(cuda):
    """Staging the host arrays and replaying a whole 16-step block, greedy
    and sampling (sampler included), under sync debug mode "error"."""
    import numpy as np

    model = _engine_model("tinyllama2")
    eng = _engine(model, "int8", graphs=True, max_batch=8)
    eng.warmup(include_sampling=True)
    tokens = np.arange(8, dtype=np.int32)
    pos = np.array([5, 9, 0, 40, 136, 3, 136, 77], np.int32)  # 136 = S: inactive
    outs = []
    torch.cuda.set_sync_debug_mode("error")  # any host synchronization raises
    try:
        for t in (0.0, 0.7):
            outs.append(eng.launch_decode_block(tokens, pos, np.full(8, t, np.float32), 16))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(tuple(o.shape) == (8, 16) for o in outs)
    assert bool(((outs[1] >= 0) & (outs[1] < model[2].vocab_size)).all())


def test_sampling_blocks_draw_anew_and_the_seed_repeats_them(cuda):
    """The sampler's generator is registered with the sampling graphs: two
    replays of one block from the same inputs draw different tokens, and an
    engine of the same seed draws the same two blocks again."""
    import numpy as np

    model = _engine_model("tiny")
    args = (np.arange(4, dtype=np.int32), np.full(4, 3, np.int32), np.full(4, 1.0, np.float32))
    runs = []
    for _ in range(2):
        eng = _engine(model, "int8", graphs=True, seed=11)
        runs.append([eng.run_decode_block(*args, 16) for _ in range(2)])
        assert (16, True) in eng.graphs
    assert not np.array_equal(runs[0][0], runs[0][1])
    assert all(np.array_equal(a, b) for a, b in zip(*runs))


def test_a_failed_capture_raises_and_nothing_runs_eager(cuda):
    """A step that synchronizes with the host cannot be captured: the engine
    raises and keeps no graph (in a process of its own, since a failed
    capture can leave the thread on the capture stream)."""
    import subprocess
    import sys

    code = """
import numpy as np, torch, pytest
import qtpu_torch.serve.batching as tb
from qtpu_torch.models import llama
from qtpu_torch.models.config import TINY_TEST as cfg
inner = tb.decode_multi
def syncing(*a, **k):
    out = inner(*a, **k)
    out[0].sum().item()
    return out
tb.decode_multi = syncing
eng = tb.ContinuousBatcher(llama.init_params(cfg, device="cuda"), cfg, max_batch=2,
                           max_seq_len=64, kv_dtype="int8", device="cuda")
with pytest.raises(RuntimeError):
    eng.warmup()
assert not eng.graphs
print("raised")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and "raised" in out.stdout, out.stdout + out.stderr


def _write_hf_llama_2layer(d, cfg, gen):
    """A 2-layer HF Llama checkpoint of cfg's widths in d: config.json and
    one bf16 safetensors file, written without the safetensors package (the
    card's machine has none). Returns {name: tensor on the card}."""
    import json

    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"model.embed_tokens.weight": (V, D), "model.norm.weight": (D,),
              "lm_head.weight": (V, D)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (D,),
                       p + "post_attention_layernorm.weight": (D,),
                       p + "self_attn.q_proj.weight": (cfg.q_dim, D),
                       p + "self_attn.k_proj.weight": (cfg.kv_dim, D),
                       p + "self_attn.v_proj.weight": (cfg.kv_dim, D),
                       p + "self_attn.o_proj.weight": (D, cfg.q_dim),
                       p + "mlp.gate_proj.weight": (F, D), p + "mlp.up_proj.weight": (F, D),
                       p + "mlp.down_proj.weight": (D, F)})
    t = {n: (torch.randn(s, generator=gen, device="cuda") * (0.1 if len(s) == 1 else 0.02)
             + (1.0 if len(s) == 1 else 0.0)).to(torch.bfloat16) for n, s in shapes.items()}
    header, off = {}, 0
    for n, x in t.items():
        header[n] = {"dtype": "BF16", "shape": list(x.shape),
                     "data_offsets": [off, off + 2 * x.numel()]}
        off += 2 * x.numel()
    h = json.dumps(header).encode()
    with open(d / "model.safetensors", "wb") as f:
        f.write(len(h).to_bytes(8, "little") + h)
        for x in t.values():
            f.write(x.cpu().view(torch.int16).numpy())
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": V, "hidden_size": D, "intermediate_size": F,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "rms_norm_eps": cfg.norm_eps,
        "max_position_embeddings": cfg.max_seq_len, "tie_word_embeddings": False}))
    return t


def test_checkpoint_to_artifact_to_served_tokens(cuda, tmp_path):
    """A 2-layer TinyLlama-width checkpoint imported to the card bit for
    bit, packed RTN W4 g128, saved and loaded to the card bit for bit; the
    loaded artifact's greedy tokens (int8 cache, graphs) equal those of
    the packed params it was saved from."""
    import numpy as np

    from qtpu_torch.ckpt import load_quantized, save_quantized
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.models.hf_import import config_from_hf, load_checkpoint
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.batching import ContinuousBatcher

    cfg = TINYLLAMA_1_1B.replace(num_layers=2)
    written = _write_hf_llama_2layer(tmp_path, cfg, _gen())
    assert config_from_hf(str(tmp_path)).replace(norm_topk_prob=True) == cfg
    params, tok = load_checkpoint(str(tmp_path), device="cuda")
    assert tok is None and params["embed"].is_cuda
    for i in range(2):
        for site, hf in (("q_proj", "self_attn.q_proj"), ("down_proj", "mlp.down_proj")):
            want = written[f"model.layers.{i}.{hf}.weight"].T.contiguous()
            assert torch.equal(params["layers"][site]["w"][i].view(torch.int16),
                               want.view(torch.int16))
    assert torch.equal(params["lm_head"]["w"].view(torch.int16),
                       written["lm_head.weight"].T.contiguous().view(torch.int16))
    mcfg = {"w_bit": 4, "q_group_size": 128}
    packed, qmeta = pack_model(params, "rtn", mcfg)
    save_quantized(tmp_path / "art", packed, qmeta, {"method": "rtn", **mcfg})
    loaded, qm, meta = load_quantized(tmp_path / "art", device="cuda")
    assert qm == qmeta and meta["method"] == "rtn"

    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            return {k: v for n, s in tree.items() for k, v in leaves(s, f"{pre}/{n}").items()}
        return {pre: tree}

    la, lb = leaves(loaded), leaves(packed)
    assert sorted(la) == sorted(lb)
    for k in lb:
        a, b = la[k], lb[k]
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), k
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 40 + 8 * i) for i in range(4)]
    outs = []
    for tree, q in ((loaded, qm), (packed, qmeta)):
        fp, fq = fuse_packed_sites(tree, q)
        eng = ContinuousBatcher(fp, cfg, qmeta=fq, max_batch=4, max_seq_len=128,
                                kv_dtype="int8", decode_block=8, seed=0, device="cuda")
        eng.warmup()
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        eng.run()
        assert all(r.done and len(r.output) == 24 for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv,per_layer", [("int8", False), ("bfloat16", False),
                                          ("int8", True)])
@pytest.mark.parametrize("hd", [80, 96, 256, 40])
def test_head_dims_qtpu_runs_launch_the_attention_kernels(cuda, tmp_path, hd, kv, per_layer):
    """A 2-layer checkpoint at head_dim 80 (hidden 640, 8 heads), 96
    (hidden 768, 8 heads, 4 kv heads), 256 (hidden 512, 2 heads, 1 kv head:
    Falcon3's head dim) or 40 (hidden 640, 16 heads, 4 kv heads) imported to
    the card, RTN W4 g128
    fused: the eval forward, a prefill of 2 x 16 and 3 greedy decode steps
    on the int8 and bf16 stacked caches and the per-layer int8 cache at S
    2048 (K12's layout), against the same model on the CPU fed the card's
    tokens, logits within the 2-layer e2e gate (3e-2). Every attention call
    launches its kernel (K5 a layer a forward on the card; K3's kernel, K11
    or K8 on the stacked caches, K12 on the per-layer one, a layer a decode
    step) and none takes the plain route (`plain_attention` stays 0, on the
    CPU too)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.kernels import flash_attention as k5
    from qtpu_torch.models import llama, ops
    from qtpu_torch.models.config import ModelConfig
    from qtpu_torch.models.hf_import import load_checkpoint
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.kvcache import init_cache

    D, H, KV = {80: (640, 8, 8), 96: (768, 8, 4), 256: (512, 2, 1), 40: (640, 16, 4)}[hd]
    cfg = ModelConfig(vocab_size=512, hidden_size=D, intermediate_size=1024, num_layers=2,
                      num_heads=H, num_kv_heads=KV, head_dim=hd)
    _write_hf_llama_2layer(tmp_path, cfg, _gen())
    params, _ = load_checkpoint(str(tmp_path), device="cuda")
    packed, qmeta = fuse_packed_sites(*pack_model(params, "rtn", {"w_bit": 4,
                                                                   "q_group_size": 128}))
    L, B, P, S = cfg.num_layers, 2, 16, 2048 if per_layer else 64
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(5))
    n0 = (ops.plain_attention.launches, k5.flash_attention.launches)
    assert _rel(llama.forward(params, ids.cuda(), cfg).cpu(),
                llama.forward(map_tree(params, lambda t: t.cpu()), ids, cfg)) < 3e-2
    assert (ops.plain_attention.launches - n0[0], k5.flash_attention.launches - n0[1]) == (
        0, L)  # the card's forward launches K5; the CPU's runs its plain version uncounted
    runs, feed = {}, None
    for dev in ("cuda", "cpu"):
        p = packed if dev == "cuda" else map_tree(packed, lambda t: t.cpu())
        cache = init_cache(cfg, B, S, quantized=kv == "int8", device=dev, per_layer=per_layer)
        pos = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        x, out, toks = ids.to(dev), [], []
        for step in range(4):
            c0 = (ops.plain_attention.launches, k23.decode_attention.launches,
                  k23.decode_attention_write.launches, k23.decode_attention_write_bf16.launches,
                  k23.decode_attention_flash.launches)
            logits, cache = llama.forward_with_cache(p, x, pos, cache, cfg, qmeta)
            torch.cuda.synchronize()
            plain = ops.plain_attention.launches - c0[0]
            kern = sum(getattr(f, "launches") for f in (
                k23.decode_attention, k23.decode_attention_write,
                k23.decode_attention_write_bf16, k23.decode_attention_flash)) - sum(c0[1:])
            assert plain == 0, (dev, step, plain)
            assert kern == (L if dev == "cuda" and step > 0 else 0), (dev, step, kern)
            out.append(logits.float().cpu())
            tok = logits[:, -1].argmax(-1) if feed is None else feed[step].to(dev)
            toks.append(tok.cpu())
            x, pos = tok.to(torch.int32)[:, None], pos[:, -1:] + 1
        runs[dev] = out
        feed = toks
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert _rel(a, b) < 3e-2


@pytest.mark.parametrize("kv", ["int8_per_layer", "bfloat16"])
def test_head_dim_past_256_takes_the_counted_plain_route(cuda, kv):
    """hd 264 (a multiple of 8 past 256) is a shape the attention kernels do
    not take: a 2-layer llama (hidden 2112, 8 heads, 4 kv heads) runs K5's
    plain version in the eval forward and K12's (the per-layer int8 cache at
    S 2048) or K8's (bf16) in each decode step on the card, each call counted
    by `plain_attention` (a layer a forward or step), no attention kernel
    launching; logits within 3e-2 of the CPU's, fed the card's tokens. The
    kernels' own entries raise on it (K2's too: the stacked int8 cache's
    decode does not run there)."""
    from qtpu_torch.convert import map_tree
    from qtpu_torch.kernels import flash_attention as k5
    from qtpu_torch.models import llama, ops
    from qtpu_torch.models.config import ModelConfig
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.serve.kvcache import init_cache

    hd, per_layer = 264, kv == "int8_per_layer"
    cfg = ModelConfig(vocab_size=512, hidden_size=8 * hd, intermediate_size=1024, num_layers=2,
                      num_heads=8, num_kv_heads=4, head_dim=hd)
    L, B, P, S = cfg.num_layers, 2, 16, 2048 if per_layer else 32
    raw = llama.init_params(cfg, seed=3, device="cpu")
    packed, qmeta = fuse_packed_sites(*pack_model(raw, "rtn", {"w_bit": 4, "q_group_size": 64}))
    ids = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator().manual_seed(6))
    attn = (k5.flash_attention, k23.decode_attention_flash, k23.decode_attention_write_bf16,
            k23.cache_band_write)
    c0 = [ops.plain_attention.launches] + [f.launches for f in attn]
    got = llama.forward(map_tree(raw, lambda t: t.cuda()), ids.cuda(), cfg)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), llama.forward(raw, ids, cfg)) < 3e-2
    assert ops.plain_attention.launches - c0[0] == 2 * L  # the card's forward and the CPU's
    runs, feed = {}, None
    for dev in ("cuda", "cpu"):
        p = packed if dev == "cpu" else map_tree(packed, lambda t: t.cuda())
        cache = init_cache(cfg, B, S, quantized=kv != "bfloat16", device=dev,
                           per_layer=per_layer)
        pos = torch.arange(P, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        x, out, toks = ids.to(dev), [], []
        for step in range(3):
            n0 = ops.plain_attention.launches
            logits, cache = llama.forward_with_cache(p, x, pos, cache, cfg, qmeta)
            assert ops.plain_attention.launches - n0 == (L if step > 0 else 0), (dev, step)
            out.append(logits.float().cpu())
            tok = logits[:, -1].argmax(-1) if feed is None else feed[step].to(dev)
            toks.append(tok.cpu())
            x, pos = tok.to(torch.int32)[:, None], pos[:, -1:] + 1
        runs[dev] = out
        feed = toks
    torch.cuda.synchronize()
    launched = [f.launches - n for f, n in zip(attn, c0[1:])]
    assert launched == [0, 0, 0, 0]
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert _rel(a, b) < 3e-2
    q = torch.randn(B, 8, hd, device=cuda).to(torch.bfloat16)
    cache = init_cache(cfg, B, 32, quantized=True, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        k23.decode_attention(q, cache.k, cache.v, cache.k_scale, cache.v_scale,
                             torch.zeros(B, dtype=torch.int32, device=cuda), 0)


# ------------------------------------------------- the engine's prefill buckets as CUDA graphs

def _bucket_engine(model, kv, graphs, seed=0):
    """max_batch 4, chunk 64: qtpu's warm set P {1, 4} x Tb {16, 32, 64}."""
    from qtpu_torch.serve.batching import ContinuousBatcher

    params, qmeta, cfg = model
    per_layer = kv == "int8_per_layer"
    return ContinuousBatcher(params, cfg, qmeta=qmeta, max_batch=4,
                             max_seq_len=2040 if per_layer else 200,
                             kv_dtype="bfloat16" if kv == "bfloat16" else "int8", decode_block=8,
                             prefill_chunk=64, kv_layout="per_layer" if per_layer else None,
                             seed=seed, device="cuda", cuda_graphs=graphs)


# waves of (prompt length, max_new_tokens, temperature), each run to its end:
# singles at Tb 16, 32, 64 and a chunked one (64 + 64), then waves of 4
# admitted together at Tb 16, 32 and 64, greedy and sampled rows mixed
BUCKET_WAVES = [[(10, 5, 0.0)], [(30, 4, 0.8)], [(60, 6, 0.0)], [(100, 3, 0.7)],
                [(12, 9, 0.0), (14, 3, 0.8), (9, 5, 0.0), (15, 4, 1.0)],
                [(20, 4, 0.0), (25, 6, 0.9), (31, 3, 0.0), (18, 7, 0.0)],
                [(50, 3, 0.5), (60, 4, 0.0), (40, 5, 0.0), (63, 3, 0.8)]]


def _served_waves(eng, cfg):
    import numpy as np

    from qtpu_torch.serve.graphs import counter_cells, counter_snapshot

    rng = np.random.default_rng(8)
    before, outs = counter_snapshot(), []
    for wave in BUCKET_WAVES:
        reqs = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=m, temperature=t)
                for n, m, t in wave]
        eng.run()
        assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)
        outs.append([r.output for r in reqs])
    torch.cuda.synchronize()
    delta = {f"{w.__name__}.{a}": b - a0 for (w, a), a0, b
             in zip(counter_cells(), before, counter_snapshot()) if b != a0}
    return outs, delta


@pytest.mark.parametrize("kv", ["int8", "bfloat16", "int8_per_layer"])
def test_prefill_graphs_cross_every_bucket_as_eager_does(cuda, kv):
    """warmup() captures qtpu's warm set of prefill buckets; a staggered
    workload that runs every one of them gives the same greedy and sampled
    tokens (one seed) on the graph engine as on an eager one, with the same
    launch and route counts. The graphs share one pool with the decode
    graphs captured before them, so the sampled ids of a prefill must
    survive the decode block replayed after it."""
    model = _engine_model("tinyllama2")
    graph = _bucket_engine(model, kv, graphs=True, seed=4)
    eager = _bucket_engine(model, kv, graphs=False, seed=4)
    assert graph.warmup() > 0.0 and eager.warmup() > 0.0
    warm = set(graph.prefill_buckets)
    assert warm == {(p, t) for p in (1, 4) for t in (16, 32, 64)}
    assert set(graph.prefill_graphs) == warm and not eager.prefill_graphs
    want, want_n = _served_waves(eager, model[2])
    got, got_n = _served_waves(graph, model[2])
    assert set(graph.prefill_shapes) == set(eager.prefill_shapes) == warm
    assert graph.prefill_shapes == eager.prefill_shapes
    assert got == want
    assert got_n == want_n and got_n
    assert graph.prefill_calls == eager.prefill_calls and graph.decode_steps == eager.decode_steps
    assert set(graph.prefill_graphs) == warm  # nothing captured after warmup()


def test_a_bucket_outside_the_warm_set_is_captured_at_first_use(cuda):
    import numpy as np

    model = _engine_model("tiny")
    eng = _bucket_engine(model, "int8", graphs=True)
    eng.warmup()
    P, Tb = 2, 16  # not in qtpu's warm set, a shape run_prefill still takes
    S = eng.cache.max_len
    ids = np.arange(P * Tb, dtype=np.int32).reshape(P, Tb) % model[2].vocab_size
    firsts = eng.run_prefill(ids, np.array([0, S], np.int32), np.array([0, 1], np.int64),
                             np.array([Tb - 1, 0], np.int32), np.zeros(P, np.float32))
    assert (P, Tb) in eng.prefill_graphs and tuple(firsts.shape) == (P,)


def test_a_prefill_replays_without_a_host_sync(cuda):
    """Staging a bucket's host arrays and replaying its graph, with the
    sampler, under sync debug mode "error"."""
    import numpy as np

    model = _engine_model("tinyllama2")
    eng = _bucket_engine(model, "int8", graphs=True)
    eng.warmup()
    S = eng.cache.max_len
    ids = np.arange(4 * 32, dtype=np.int32).reshape(4, 32)
    args = (ids, np.array([0, 0, S, S], np.int32), np.arange(4, dtype=np.int64),
            np.array([31, 7, 0, 0], np.int32), np.array([0.0, 0.9, 0.0, 0.0], np.float32))
    torch.cuda.set_sync_debug_mode("error")  # any host synchronization raises
    try:
        firsts = eng.run_prefill(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(((firsts >= 0) & (firsts < model[2].vocab_size)).all())


def test_a_failed_prefill_capture_raises_and_nothing_runs_eager(cuda):
    """A prefill that synchronizes with the host cannot be captured: warmup()
    raises after the decode graphs and keeps no prefill graph (in a process
    of its own, as the decode test)."""
    import subprocess
    import sys

    code = """
import numpy as np, torch, pytest
import qtpu_torch.serve.batching as tb
from qtpu_torch.models import llama
from qtpu_torch.models.config import TINY_TEST as cfg
inner = tb.prefill_full
def syncing(*a, **k):
    out = inner(*a, **k)
    out[0].sum().item()
    return out
tb.prefill_full = syncing
eng = tb.ContinuousBatcher(llama.init_params(cfg, device="cuda"), cfg, max_batch=2,
                           max_seq_len=64, kv_dtype="int8", device="cuda")
with pytest.raises(RuntimeError):
    eng.warmup()
assert eng.graphs and not eng.prefill_graphs
print("raised")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and "raised" in out.stdout, out.stdout + out.stderr


def test_synth_weights_are_one_layer_on_the_card(cuda):
    """tiled_packed_llama at TinyLlama's widths (4 layers) allocates about one
    layer's packed weights plus the embedding and lm_head, and a forward on
    it equals one on a materialized copy (every layer's bytes its own)."""
    from qtpu_torch.bench.synth import tiled_packed_llama
    from qtpu_torch.convert import map_tree
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B

    cfg = TINYLLAMA_1_1B.replace(num_layers=4)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params, qmeta = tiled_packed_llama(cfg)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - m0
    D, F, V, Q, KV = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.q_dim,
                      cfg.kv_dim)
    layer = sum(k * n // 2 + 3 * (k // 128) * n for k, n in
                ((D, Q + 2 * KV), (Q, D), (D, 2 * F), (F, D)))
    outer = V * D * 2 + D * V // 2 + 3 * (D // 128) * V
    assert held < layer + outer + (4 << 20), (held, layer, outer)
    dense = map_tree(params, lambda t: t.contiguous())
    ids = torch.randint(0, V, (2, 64), device=cuda)
    a = llama.forward(params, ids, cfg, qmeta)
    b = llama.forward(dense, ids, cfg, qmeta)
    assert _rel(a, b) < 1e-3 and bool(torch.isfinite(a).all())


def test_native_packer_on_the_card_machine(cuda):
    """The host library builds on the card's machine and packs TinyLlama's
    site widths as qtpu_torch.core.packing does."""
    import numpy as np

    from qtpu_torch import native

    assert native.available()
    w = (np.random.default_rng(0).standard_normal((2048, 5632)) * 0.02).astype(np.float32)
    data, scales, zeros = native.quantize_pack(w, 4, 128)
    qt = quantize_pack(torch.from_numpy(w), 4, 128)
    assert np.array_equal(data, qt.data.numpy()) and np.array_equal(zeros, qt.zeros.numpy())
    assert torch.equal(torch.from_numpy(scales).bfloat16(), qt.scales)


def test_utils_on_the_card(cuda, tmp_path):
    """Timer's host seconds agree with its CUDA events on a long device
    span; checked() catches a NaN made mid-function on the card; a
    profile_trace of a K1 call names its kernel."""
    import json

    from qtpu_torch.utils import debug, timing

    a = torch.randn(4096, 4096, device=cuda)
    with timing.Timer(a) as t:
        for _ in range(20):
            a = torch.tanh(a @ a * 1e-2)
    assert abs(t.elapsed - t.device_elapsed) < 0.05 * t.device_elapsed, (t.elapsed, t.device_elapsed)

    def inner_nan(x):
        y = torch.sqrt(x - 1.0)  # NaN where x < 1
        return torch.nan_to_num(y)

    x = torch.rand(64, device=cuda)
    assert bool(torch.isfinite(inner_nan(x)).all())
    with pytest.raises(FloatingPointError):
        debug.checked(inner_nan)(x)
    g = _gen()
    qt = quantize_pack(torch.randn(512, 384, generator=g, device=cuda) * 0.02, 4, 128)
    xb = torch.randn(300, 512, generator=g, device=cuda).to(torch.bfloat16)
    k1.quantized_matmul(xb, qt.data, qt.scales, qt.zeros, (4, 128, 512, 384))
    with timing.profile_trace(str(tmp_path)):
        k1.quantized_matmul(xb, qt.data, qt.scales, qt.zeros, (4, 128, 512, 384))
        torch.cuda.synchronize()
    (f,) = tmp_path.glob("trace-*.json")
    names = {e.get("name", "") for e in json.loads(f.read_text())["traceEvents"]}
    assert any("dq_wgmma_kernel" in n for n in names)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("D,F", [(512, 1024), (2048, 2816)])
def test_k4_no_residual_matches_plain(cuda, bits, M, D, F):
    """K4's no-residual mode (a tensor-parallel rank other than the group's
    first; F 2816 is TinyLlama's MLP at TP 2) against its plain version, on
    the body its rule names, and beside the residual mode minus x."""
    g = _gen()
    gu = quantize_pack(torch.randn(D, 2 * F, generator=g, device=cuda) * 0.05, bits, 128)
    dn = quantize_pack(torch.randn(F, D, generator=g, device=cuda) * 0.05, bits, 128)
    nw = (1.0 + 0.1 * torch.randn(D, generator=g, device=cuda)).to(torch.bfloat16)
    x = torch.randn(M, 1, D, generator=g, device=cuda).to(torch.bfloat16)
    args = (x, nw, gu.data, gu.scales, gu.zeros, dn.data, dn.scales, dn.zeros,
            (bits, 128, D, 2 * F), (bits, 128, F, D))
    t0 = k4.fused_mlp.gemv_tc_launches
    got = k4.fused_mlp(*args, resid=False)
    tc = k4.fused_mlp.gemv_tc_launches - t0
    want = k4.fused_mlp_plain(*args, resid=False)
    with_x = k4.fused_mlp(*args)
    torch.cuda.synchronize()
    assert tc == (1 if M <= 8 else 0)
    assert _rel(got, want) < 3e-2
    assert _rel(got, with_x.float() - x.float()) < 1e-2


def _tp_model(dev, layers=2):
    """A TinyLlama-width llama of `layers` layers, RTN W4 g128, fused."""
    from qtpu_torch.models import llama
    from qtpu_torch.models.config import TINYLLAMA_1_1B
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    cfg = TINYLLAMA_1_1B.replace(num_layers=layers)
    params = llama.init_params(cfg, seed=0, device=dev)
    packed, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 128})
    packed, qmeta = fuse_packed_sites(packed, qmeta)
    return cfg, packed, qmeta


def _tp_serve(cfg, packed, qmeta, mesh, tp, prompt, steps):
    """Prefill + `steps` greedy decode steps; the logits of every step."""
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding.specs import shard_model

    if mesh is not None:
        packed, qmeta, cfg = shard_model(packed, qmeta, cfg, mesh)
    B, T = prompt.shape
    cache = init_cache(cfg, B, T + steps + 8, quantized=True, device=prompt.device)
    logits, cache = prefill(packed, prompt, cache, cfg, qmeta, tp=tp)
    out = [logits]
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), T, dtype=torch.int32, device=prompt.device)
    for _ in range(steps):
        logits, cache = decode_step(packed, tok, pos, cache, cfg, qmeta, tp=tp)
        out.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1
    return torch.stack(out, 1)


def test_tp_one_rank_nccl_forward_is_bit_equal(cuda, tmp_path):
    """The tensor-parallel code in a 1-rank NCCL world (all-reduces and the
    logits' all-gather on one rank) gives the unsharded path's bits."""
    import torch.distributed as dist

    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.multihost import initialize_multihost

    cfg, packed, qmeta = _tp_model(cuda)
    prompt = torch.randint(0, cfg.vocab_size, (8, 64), generator=_gen(), device=cuda)
    want = _tp_serve(cfg, packed, qmeta, None, None, prompt, 3)
    initialize_multihost(f"file://{tmp_path / 'init'}", 1, 0, device="cuda")
    try:
        mesh = make_mesh(data=1, model=1)
        got = _tp_serve(cfg, packed, qmeta, mesh, local_group(mesh, "model"), prompt, 3)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, want)


def _tp2_card_worker(rank, world, d):
    from qtpu_torch.sharding.mesh import local_group, make_mesh

    dev = torch.device("cuda", 0)
    cfg, packed, qmeta = _tp_model(dev)
    prompt = torch.randint(0, cfg.vocab_size, (8, 64), generator=_gen(), device=dev)
    mesh = make_mesh(data=1, model=2)
    got = _tp_serve(cfg, packed, qmeta, mesh, local_group(mesh, "model"), prompt, 1)
    out = {"got": got.cpu()}
    if rank == 0:
        out["want"] = _tp_serve(cfg, packed, qmeta, None, None, prompt, 1).cpu()
    torch.save(out, f"{d}/rank{rank}.pt")


def test_tp2_gloo_decode_step_on_the_card(cuda, tmp_path):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one card):
    a TP 2 prefill and decode step of a 2-layer TinyLlama-width W4 model
    within 3e-2 of the one-rank run, both ranks with the same logits."""
    from qtpu_torch.sharding.multihost import spawn

    spawn(_tp2_card_worker, 2, (str(tmp_path),), init_file=str(tmp_path / "init"),
          device="cuda", timeout_s=300)
    r0 = torch.load(tmp_path / "rank0.pt")
    r1 = torch.load(tmp_path / "rank1.pt")
    assert torch.equal(r0["got"], r1["got"])
    assert _rel(r0["got"], r0["want"]) < 3e-2
