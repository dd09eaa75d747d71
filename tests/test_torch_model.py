"""The port's model path against qtpu on the same numpy-made weights:
pack_model + fuse_packed_sites give identical leaves, forward_with_cache
gives the same prefill and decode logits (dense and W4-packed, int8 and
bf16 KV cache; the llama-arch variants Qwen2, with q/k/v biases, and
Mistral, with a sliding window, on the int8 cache in both layouts), and
greedy decoding picks qtpu's tokens wherever qtpu's top-1/top-2 margin is
wider than the logit tolerance."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from qtpu.models import llama as jllama
from qtpu.models.config import TINY_MISTRAL_TEST, TINY_QWEN2_TEST, TINY_TEST
from qtpu.quant.apply import fuse_packed_sites as jax_fuse
from qtpu.quant.apply import pack_model as jax_pack
from qtpu.serve import decode as jdecode
from qtpu.serve.kvcache import init_cache as jax_init_cache
from qtpu_torch.convert import params_to_numpy, params_to_torch, to_numpy, to_torch
from qtpu_torch.models import llama as tllama
from qtpu_torch.models import config as tconfig
from qtpu_torch.models.config import TINY_TEST as T_TINY
from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
from qtpu_torch.serve import decode as tdecode
from qtpu_torch.serve.kvcache import init_cache


def cpu(a):
    """numpy -> a tensor on the CPU (the port's entry points default to cuda)."""
    return to_torch(a, device="cpu")


BF16 = ml_dtypes.bfloat16
CFG = TINY_TEST
# relative Frobenius error of the f32 logits: both sides run bf16 layers,
# rounded and summed in another order (XLA vs PyTorch CPU kernels)
LOGIT_TOL = 2e-2


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    D, F, V, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    Q, KV = cfg.q_dim, cfg.kv_dim

    def w(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32).astype(BF16)

    def norm(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32).astype(BF16)

    params = {
        "embed": w(V, D),
        "layers": {
            "attn_norm": norm(L, D), "mlp_norm": norm(L, D),
            "q_proj": {"w": w(L, D, Q)}, "k_proj": {"w": w(L, D, KV)},
            "v_proj": {"w": w(L, D, KV)}, "o_proj": {"w": w(L, Q, D)},
            "gate_proj": {"w": w(L, D, F)}, "up_proj": {"w": w(L, D, F)},
            "down_proj": {"w": w(L, F, D)},
        },
        "final_norm": norm(D),
        "lm_head": {"w": w(D, V)},
    }
    if cfg.attention_bias:  # Qwen2: q/k/v biases
        for site, n in (("q_proj", Q), ("k_proj", KV), ("v_proj", KV)):
            params["layers"][site]["b"] = (rng.standard_normal((L, n)) * 0.5).astype(
                np.float32).astype(BF16)
    return params


def _both(packed: bool, cfg=CFG):
    p = _np_params(cfg)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = params_to_torch(p, device="cpu")
    if not packed:
        return pj, None, pt, None
    mcfg = {"w_bit": 4, "q_group_size": 64}
    pj, qj = jax_fuse(*jax_pack(pj, "rtn", mcfg))
    pt, qt = fuse_packed_sites(*pack_model(pt, "rtn", mcfg))
    return pj, qj, pt, qt


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-6))


def test_pack_and_fuse_leaves_equal():
    pj, qj, pt, qt = _both(packed=True)
    assert qt == qj
    assert set(pt["layers"]) == set(pj["layers"])
    assert "qkv_proj" in pt["layers"] and "gateup_proj" in pt["layers"]
    flat_t = jax.tree_util.tree_flatten_with_path(params_to_numpy(pt))[0]
    flat_j = dict(jax.tree_util.tree_flatten_with_path(pj)[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_t:
        want = np.asarray(flat_j[path])
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, path
        if leaf.dtype == BF16:
            leaf, want = leaf.view(np.uint16), want.view(np.uint16)
        np.testing.assert_array_equal(leaf, want, err_msg=str(path))


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "w4"])
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_forward_with_cache_matches_qtpu(packed, kv):
    pj, qj, pt, qt = _both(packed)
    B, T, steps, S = 2, 8, 3, 32
    quant = kv == "int8"
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, T), dtype=np.int32)
    start = np.array([0, 2], np.int32)  # sequences at different offsets
    positions = start[:, None] + np.arange(T, dtype=np.int32)[None, :]
    cj = jax_init_cache(CFG, B, S, quantized=quant)
    ct = init_cache(T_TINY, B, S, quantized=quant, device="cpu")
    lj, cj = jllama.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(positions), cj, CFG, qj)
    lt, ct = tllama.forward_with_cache(pt, cpu(ids), cpu(positions), ct, T_TINY, qt)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    pos = positions[:, -1] + 1
    for _ in range(steps):  # decode, teacher-forced with qtpu's greedy tokens
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        lj, cj = jllama.forward_with_cache(
            pj, jnp.asarray(tok)[:, None], jnp.asarray(pos)[:, None], cj, CFG, qj)
        lt, ct = tllama.forward_with_cache(
            pt, cpu(tok)[:, None], cpu(pos)[:, None], ct, T_TINY, qt)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        pos = pos + 1
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    if quant:  # the k/v rows differ by bf16 rounding: compare dequantized caches
        for a, sa, b, sb in ((ct.k, ct.k_scale, cj.k, cj.k_scale),
                             (ct.v, ct.v_scale, cj.v, cj.v_scale)):
            got = to_numpy(a).astype(np.float32) * to_numpy(sa)[..., None]
            want = np.asarray(b, np.float32) * np.asarray(sb)[..., None]
            assert _rel(got, want) < LOGIT_TOL
    else:
        assert _rel(to_numpy(ct.k), np.asarray(cj.k)) < LOGIT_TOL


@pytest.mark.parametrize("variant,per_layer", [("qwen2", False), ("qwen2", True),
                                               ("mistral", False), ("mistral", True)])
def test_llama_variants_match_qtpu(variant, per_layer):
    """TINY_QWEN2_TEST (q/k/v biases) and TINY_MISTRAL_TEST (window 8), RTN
    W4 fused, on the int8 cache: a prefill of 12 and 6 teacher-forced decode
    steps against qtpu, the stacked cache at S 32 (K2 + K3's plain versions)
    and the per-layer one at S 2048 (K12's plain version: strictly before
    pos plus the unquantized new token, where qtpu's CPU path quantizes it
    first; both within the same tolerance)."""
    cfg = {"qwen2": TINY_QWEN2_TEST, "mistral": TINY_MISTRAL_TEST}[variant]
    tcfg = {"qwen2": tconfig.TINY_QWEN2_TEST, "mistral": tconfig.TINY_MISTRAL_TEST}[variant]
    pj, qj, pt, qt = _both(packed=True, cfg=cfg)
    assert ("b" in pt["layers"]["qkv_proj"]) == (variant == "qwen2")
    B, T, steps = 2, 12, 6
    S = 2048 if per_layer else 32
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    positions = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    cj = jax_init_cache(cfg, B, S, quantized=True, per_layer=per_layer)
    ct = init_cache(tcfg, B, S, quantized=True, device="cpu", per_layer=per_layer)
    lj, cj = jllama.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(positions), cj, cfg, qj)
    lt, ct = tllama.forward_with_cache(pt, cpu(ids), cpu(positions), ct, tcfg, qt)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    pos = np.full((B,), T, np.int32)
    for _ in range(steps):  # past the window of 8
        tok = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
        lj, cj = jllama.forward_with_cache(
            pj, jnp.asarray(tok)[:, None], jnp.asarray(pos)[:, None], cj, cfg, qj)
        lt, ct = tllama.forward_with_cache(pt, cpu(tok)[:, None], cpu(pos)[:, None], ct, tcfg, qt)
        assert _rel(lt.numpy(), lj) < LOGIT_TOL
        pos = pos + 1
    assert ct.per_layer == per_layer


def test_greedy_generate_matches_qtpu():
    pj, qj, pt, qt = _both(packed=True)
    B, T, n = 2, 8, 6
    ids = np.random.default_rng(2).integers(0, CFG.vocab_size, (B, T), dtype=np.int32)
    toks_j, _ = jdecode.greedy_generate(
        pj, jnp.asarray(ids), jax_init_cache(CFG, B, 32, quantized=True), CFG, n, qj)
    toks_j = np.asarray(toks_j)
    toks_t, _ = tdecode.greedy_generate(
        pt, cpu(ids), init_cache(T_TINY, B, 32, quantized=True, device="cpu"), T_TINY, n, qt)
    assert tuple(toks_t.shape) == (B, n)
    # teacher-forced: feed qtpu's tokens to both, compare the port's argmax
    # wherever qtpu's top-1/top-2 margin exceeds the logit tolerance
    cj = jax_init_cache(CFG, B, 32, quantized=True)
    ct = init_cache(T_TINY, B, 32, quantized=True, device="cpu")
    lj, cj = jdecode.prefill(pj, jnp.asarray(ids), cj, CFG, qj)
    lt, ct = tdecode.prefill(pt, cpu(ids), ct, T_TINY, qt)
    pos = np.full((B,), T, np.int32)
    checked = 0
    for i in range(n):
        lj_np = np.asarray(lj)
        top2 = np.sort(lj_np, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        tol = LOGIT_TOL * np.linalg.norm(lj_np, axis=-1) / np.sqrt(lj_np.shape[-1])
        want = lj_np.argmax(-1)
        np.testing.assert_array_equal(want, toks_j[:, i])
        got = lt.numpy().argmax(-1)
        sure = margin > 4 * tol
        np.testing.assert_array_equal(got[sure], want[sure])
        checked += int(sure.sum())
        tok = toks_j[:, i].astype(np.int32)
        lj, cj = jdecode.decode_step(pj, jnp.asarray(tok), jnp.asarray(pos), cj, CFG, qj)
        lt, ct = tdecode.decode_step(pt, cpu(tok), cpu(pos), ct, T_TINY, qt)
        pos = pos + 1
    assert checked >= B * n // 2  # most steps are decisive at this size
