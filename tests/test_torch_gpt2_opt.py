"""The port's GPT-2 and OPT decoders against qtpu on the CPU, on the same
numpy-made weights, packed bytes and token ids (TINY_GPT2_TEST and
TINY_OPT_TEST): the dense forward and its calibration capture, pack_model
for rtn and awq (bytes equal, OPT's q/k/v fused), the packed forward,
prefill plus teacher-forced cached decode on the int8 and the bf16 KV cache,
the serve CLI; and K1's plain version at a ragged N (GPT-2's lm_head is
50257 wide) against qtpu's `quantized_matmul`. The port takes the route its
card takes through the kernels' plain versions; qtpu the XLA path."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from qtpu.calib import collect_calibration_stats as jax_collect
from qtpu.core.packing import quantize_pack as jax_quantize_pack
from qtpu.kernels.dequant_matmul import quantized_matmul as jax_qmm
from qtpu.models import gpt2 as jgpt2
from qtpu.models import opt as jopt
from qtpu.models.config import TINY_GPT2_TEST as J_GPT2
from qtpu.models.config import TINY_OPT_TEST as J_OPT
from qtpu.quant.apply import fuse_packed_sites as jax_fuse
from qtpu.quant.apply import pack_model as jax_pack
from qtpu.serve.kvcache import init_cache as jax_init_cache
from qtpu_torch.convert import params_to_numpy, params_to_torch, stats_to_torch, to_numpy, to_torch
from qtpu_torch.core.packing import quantize_pack
from qtpu_torch.kernels.dequant_matmul import quantized_matmul
from qtpu_torch.models import get_arch
from qtpu_torch.models import config as tconfig
from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
from qtpu_torch.serve.__main__ import main as serve_main
from qtpu_torch.serve.kvcache import init_cache
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

BF16 = ml_dtypes.bfloat16
LOGIT_TOL = 2e-2  # relative Frobenius error of the f32 logits (bf16 layers, other sum orders)
ARCHS = {"gpt2": (jgpt2, J_GPT2, tconfig.TINY_GPT2_TEST),
         "opt": (jopt, J_OPT, tconfig.TINY_OPT_TEST)}
RTN4 = {"w_bit": 4, "q_group_size": 64}


def cpu(a):
    return to_torch(np.ascontiguousarray(a), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def _np_params(arch, cfg, seed=0):
    """numpy params in qtpu's layout (bf16): weights N(0, 0.05), biases
    N(0, 0.02), LayerNorm weights near 1 and biases near 0, the lm_head
    its own copy of the embedding's transpose."""
    rng = np.random.default_rng(seed)
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    P = cfg.max_seq_len + (2 if arch == "opt" else 0)

    def w(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)

    def site(k, n):
        return {"w": w(L, k, n), "b": w(L, n, scale=0.02)}

    layers = {"ln1_w": (1.0 + w(L, D, scale=0.1).astype(np.float32)).astype(BF16),
              "ln1_b": w(L, D, scale=0.02),
              "ln2_w": (1.0 + w(L, D, scale=0.1).astype(np.float32)).astype(BF16),
              "ln2_b": w(L, D, scale=0.02)}
    if arch == "gpt2":
        layers.update(c_attn=site(D, 3 * D), attn_out=site(D, D), mlp_fc=site(D, F),
                      mlp_proj=site(F, D))
    else:
        layers.update(q_proj=site(D, D), k_proj=site(D, D), v_proj=site(D, D),
                      out_proj=site(D, D), fc1=site(D, F), fc2=site(F, D))
    embed = w(V, D)
    return {"embed": embed, "pos_embed": w(P, D, scale=0.02), "layers": layers,
            "final_norm_w": np.ones((D,), BF16), "final_norm_b": w(D, scale=0.02),
            "lm_head": {"w": np.ascontiguousarray(embed.T)}}


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """(arch, qtpu module, qtpu cfg, port cfg, numpy params, qtpu params,
    port params, both packed RTN W4 g64 and fused)."""
    arch = request.param
    jm, cj, ct = ARCHS[arch]
    p = _np_params(arch, ct)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = params_to_torch(p, device="cpu")
    packed_j = jax_fuse(*jax_pack(pj, "rtn", RTN4, arch=arch), arch=arch)
    packed_t = fuse_packed_sites(*pack_model(pt, "rtn", RTN4, arch=arch), arch=arch)
    return SimpleNamespace(arch=arch, jm=jm, cj=cj, ct=ct, p=p, pj=pj, pt=pt, packed_j=packed_j,
                           packed_t=packed_t)


def _assert_leaves_equal(pt, pj):
    flat_t = jax.tree_util.tree_flatten_with_path(params_to_numpy(pt))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(pj)[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        want = np.asarray(flat_j[path])
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, path
        if leaf.dtype == BF16:
            leaf, want = leaf.view(np.uint16), want.view(np.uint16)
        np.testing.assert_array_equal(leaf, want, err_msg=str(path))


def test_forward_and_capture_match_qtpu(model):
    """Dense forward logits, and the capture statistics calibration reads
    (mean and max |x| per input site and layer, head_in without one)."""
    ids = np.random.default_rng(1).integers(0, model.ct.vocab_size, (2, 24), dtype=np.int32)
    tm = get_arch(model.arch)
    lj, sj = model.jm.forward(model.pj, jnp.asarray(ids), model.cj, capture="stats")
    lt, st = tm.forward(model.pt, cpu(ids).long(), model.ct, capture="stats")
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    assert set(st) == set(sj) == set(tm.INPUT_SITES)
    for site in tm.INPUT_SITES:
        for key in ("mean_abs", "max_abs"):
            got, want = st[site][key].numpy(), np.asarray(sj[site][key])
            assert got.shape == want.shape, (site, key)
            assert _rel(got, want) < LOGIT_TOL, (site, key)


def test_pack_rtn_bytes_equal_qtpu(model):
    """RTN W4 g64 packed and fused: every leaf (codes, scales, zeros,
    biases; OPT's qkv_proj with its concatenated bias) equal, and qmeta."""
    pt, qt = model.packed_t
    pj, qj = model.packed_j
    assert qt == qj
    want = {"opt": {"qkv_proj", "out_proj", "fc1", "fc2"},
            "gpt2": {"c_attn", "attn_out", "mlp_fc", "mlp_proj"}}[model.arch]
    assert {k for k, v in pt["layers"].items() if isinstance(v, dict)} == want
    _assert_leaves_equal(pt, pj)


def test_pack_awq_bytes_equal_qtpu(model):
    """AWQ W4 g64 on qtpu's calibration statistics (four batches of 32
    ids), moved to the port: every packed leaf and the input smooth vectors
    equal."""
    batches = [np.random.default_rng(i).integers(0, model.ct.vocab_size, (1, 32), dtype=np.int32)
               for i in range(4)]
    js = jax_collect(model.jm.forward, model.pj, batches, model.cj)
    js_np = SimpleNamespace(**{f: {k: np.asarray(v) for k, v in getattr(js, f).items()}
                               for f in ("mean_abs", "max_abs")}, hessian=None,
                            n_batches=js.n_batches)
    mcfg = {"w_bit": 4, "q_group_size": 64, "protect_ratio": 0.02}
    pj, qj = jax_pack(model.pj, "awq", mcfg, js, arch=model.arch)
    pt, qt = pack_model(model.pt, "awq", mcfg, stats_to_torch(js_np, device="cpu"),
                        arch=model.arch)
    assert qt == qj
    _assert_leaves_equal(pt, pj)


def test_packed_forward_matches_qtpu(model):
    ids = np.random.default_rng(2).integers(0, model.ct.vocab_size, (2, 16), dtype=np.int32)
    (pj, qj), (pt, qt) = model.packed_j, model.packed_t
    lj = model.jm.forward(pj, jnp.asarray(ids), model.cj, qmeta=qj)
    lt = get_arch(model.arch).forward(pt, cpu(ids).long(), model.ct, qmeta=qt)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_cached_decode_matches_qtpu(model, kv):
    """Packed W4: a prefill of 8 (sequences at offsets 0 and 3) and 4
    decode steps teacher-forced with qtpu's greedy tokens, on both caches;
    the caches after dequantization within the same tolerance."""
    (pj, qj), (pt, qt) = model.packed_j, model.packed_t
    tm = get_arch(model.arch)
    B, T, steps, S = 2, 8, 4, 40
    quant = kv == "int8"
    ids = np.random.default_rng(3).integers(0, model.ct.vocab_size, (B, T), dtype=np.int32)
    positions = np.array([0, 3], np.int32)[:, None] + np.arange(T, dtype=np.int32)[None]
    cj = jax_init_cache(model.cj, B, S, quantized=quant)
    ct = init_cache(model.ct, B, S, quantized=quant, device="cpu")
    lj, cj = model.jm.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(positions), cj,
                                         model.cj, qj)
    lt, ct = tm.forward_with_cache(pt, cpu(ids), cpu(positions), ct, model.ct, qt)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    pos = positions[:, -1] + 1
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        lj, cj = model.jm.forward_with_cache(pj, jnp.asarray(tok)[:, None],
                                             jnp.asarray(pos)[:, None], cj, model.cj, qj)
        lt, ct = tm.forward_with_cache(pt, cpu(tok)[:, None], cpu(pos)[:, None], ct, model.ct,
                                       qt)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        pos = pos + 1
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    if quant:
        for a, sa, b, sb in ((ct.k, ct.k_scale, cj.k, cj.k_scale),
                             (ct.v, ct.v_scale, cj.v, cj.v_scale)):
            got = to_numpy(a).astype(np.float32) * to_numpy(sa)[..., None]
            want = np.asarray(b, np.float32) * np.asarray(sb)[..., None]
            assert _rel(got, want) < LOGIT_TOL
    else:
        assert _rel(to_numpy(ct.k), np.asarray(cj.k)) < LOGIT_TOL


def test_per_layer_cache_raises(model):
    cache = init_cache(model.ct, 1, 16, quantized=True, device="cpu", per_layer=True)
    with pytest.raises(NotImplementedError, match="stacked KV cache"):
        get_arch(model.arch).forward_with_cache(
            model.pt, torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, 1, dtype=torch.int32),
            cache, model.ct)


def test_serve_cli(model, capsys):
    """`python -m qtpu_torch.serve --model tiny-<arch>-test` with RTN W4 on
    the int8 cache: every request gets its tokens."""
    rc = serve_main(["--model", f"tiny-{model.arch}-test", "--device", "cpu", "--kv", "int8",
                     "--requests", "2", "--tokens", "3", "--batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "packed model with rtn W4 g64" in out and "2 requests, 6 tokens" in out


@pytest.mark.parametrize("bits,N", [(4, 771), (8, 257)])
def test_k1_plain_at_ragged_n_matches_qtpu(bits, N):
    """quantize_pack bytes at an N that is not a multiple of 4 equal
    qtpu's (the layout packs along K, so N is free), and K1's plain version
    equals qtpu's quantized_matmul on the CPU (its XLA reference; qtpu's
    dispatcher sends such N there on every backend)."""
    K, g = 256, 64
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32).astype(BF16)
    x = rng.standard_normal((3, K)).astype(np.float32).astype(BF16)
    qj = jax_quantize_pack(jnp.asarray(w), bits, g)
    qt = quantize_pack(cpu(w), bits, g)
    for got, want in ((qt.data, qj.data), (qt.scales, qj.scales), (qt.zeros, qj.zeros)):
        got = to_numpy(got)
        want = np.asarray(want)
        if got.dtype == BF16:
            got, want = got.view(np.uint16), want.view(np.uint16)
        np.testing.assert_array_equal(got, want)
    meta = (bits, g, K, N)
    yj = jax_qmm(jnp.asarray(x), qj.data, qj.scales, qj.zeros, meta)
    yt = quantized_matmul(cpu(x), qt.data, qt.scales, qt.zeros, meta)
    assert tuple(yt.shape) == (3, N)
    assert _rel(to_numpy(yt), yj) < 1e-2
