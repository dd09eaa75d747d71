"""qtpu_torch.bench.synth on the CPU against qtpu.bench.synth: the same
tree of shapes and dtypes and the same qmeta, every layer site one storage
tiled as a stride-0 view, and a forward over the port's synthetic weights
equal to qtpu's forward on the same weights (moved through numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.bench import synth as jsynth
from qtpu.models import llama as jllama
from qtpu.models import moe as jmoe
from qtpu.models.config import TINY_MOE_TEST as J_MOE
from qtpu.models.config import TINY_TEST as J_TINY
from qtpu_torch.bench import synth
from qtpu_torch.convert import params_to_numpy
from qtpu_torch.models import llama, moe
from qtpu_torch.models.config import TINY_MOE_TEST, TINY_TEST

# relative Frobenius error of the f32 logits: both sides run bf16 layers,
# rounded and summed in another order (XLA vs PyTorch CPU kernels), as in
# tests/test_torch_model.py
LOGIT_TOL = 2e-2

CASES = {
    "llama_fused": (lambda d: synth.tiled_packed_llama(TINY_TEST, device=d),
                    lambda: jsynth.tiled_packed_llama(J_TINY), llama, jllama, J_TINY),
    "llama_unfused": (lambda d: synth.tiled_packed_llama(TINY_TEST, w_bit=8, group=64, fuse=False,
                                                         device=d),
                      lambda: jsynth.tiled_packed_llama(J_TINY, 8, 64, fuse=False), llama, jllama,
                      J_TINY),
    "moe": (lambda d: synth.tiled_packed_moe(TINY_MOE_TEST, device=d),
            lambda: jsynth.tiled_packed_moe(J_MOE), moe, jmoe, J_MOE),
    "w8a8": (lambda d: synth.tiled_w8a8_llama(TINY_TEST, device=d),
             lambda: jsynth.tiled_w8a8_llama(J_TINY), llama, jllama, J_TINY),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("case", sorted(CASES))
def test_shapes_dtypes_and_qmeta_equal_qtpus(case):
    make, jmake, *_ = CASES[case]
    p, qmeta = make("cpu")
    jp, jqmeta = jmake()
    assert qmeta == jqmeta
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _leaves(p)}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(jp)}
    assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_layer_site_is_one_storage(case):
    """[L, ...] layer leaves are expand views of one layer (stride 0 over L,
    the same bytes at every l) whose W[l] is contiguous, as the kernels take
    it; the model's bytes are one layer's and not L layers'."""
    p, _ = CASES[case][0]("cpu")
    L = (TINY_MOE_TEST if case == "moe" else TINY_TEST).num_layers
    assert L > 1
    for path, t in _leaves(p["layers"]):
        assert t.shape[0] == L and t.stride(0) == 0, path
        assert len({t[l].data_ptr() for l in range(L)}) == 1 and t[0].is_contiguous(), path
        assert t.untyped_storage().nbytes() == t[0].numel() * t.element_size(), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_on_synth_weights_equals_qtpus(case):
    make, _, tmod, jmod, jcfg = CASES[case]
    cfg = TINY_MOE_TEST if case == "moe" else TINY_TEST
    p, qmeta = make("cpu")
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    got = tmod.forward(p, torch.as_tensor(ids), cfg, qmeta)
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(p))
    want = np.asarray(jmod.forward(jp, jnp.asarray(ids, jnp.int32), jcfg, qmeta=qmeta), np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < LOGIT_TOL


def test_the_generator_draws_the_weights():
    """One seed gives the same weights, another seed others."""
    a, _ = synth.tiled_packed_llama(TINY_TEST, device="cpu", seed=3)
    b, _ = synth.tiled_packed_llama(TINY_TEST, device="cpu", seed=3)
    c, _ = synth.tiled_packed_llama(TINY_TEST, device="cpu", seed=4)
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["layers"]["qkv_proj"]["data"], b["layers"]["qkv_proj"]["data"])
