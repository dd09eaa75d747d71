"""The port's ring attention (qtpu_torch.sharding.ring_attention) on the
CPU: against plain causal attention (f32 to 1e-5, bf16 to 2e-2) at n 2 and
4, chunked and with a sliding window; against qtpu's ring_attention on the
virtual CPU devices (f32, 1e-5); an uneven split raising; and
seq_sharded_forward / seq_sharded_nll against the plain forward (logits
within 2e-2, the llama TP bound; the NLL within 1e-3 relative).

One world of 4 gloo processes (run_world of tests/test_torch_sharding.py):
a ('seq',) mesh of 4 and a ('data', 'seq') mesh of 2 x 2 for n = 2.
"""

import numpy as np
import pytest
import torch

from qtpu_torch.models import config as tconfig
from test_torch_sharding import case, one_torch_thread, run_world  # noqa: F401  (a fixture)

B, S, H, KV, HD = 2, 64, 4, 2, 16
CFG = tconfig.TINY_TEST
SEQ_S = 64


def _shard(t, n, i):
    Sl = t.shape[1] // n
    return t[:, i * Sl:(i + 1) * Sl]


def ring_worker(rank, world, p):
    from qtpu_torch.models import llama
    from qtpu_torch.sharding.mesh import build_mesh
    from qtpu_torch.sharding.ring_attention import (ring_attention, seq_sharded_forward,
                                                    seq_sharded_nll)

    groups = {4: build_mesh((4,), ("seq",)).get_group("seq"),
              2: build_mesh((2, 2), ("data", "seq")).get_group("seq")}
    cases = {}
    for n, g in groups.items():
        i = rank % n
        for dt in ("f32", "bf16"):
            q, k, v = (_shard(p[dt][t], n, i) for t in "qkv")
            for chunk in (None, 8):
                for window in (0, 20):
                    cases[(n, dt, chunk, window)] = (
                        lambda q=q, k=k, v=v, g=g, c=chunk, w=window:
                        ring_attention(q, k, v, g, window=w, chunk=c))
        cases[("fwd", n)] = lambda g=g: seq_sharded_forward(p["params"], p["ids"], CFG, g,
                                                            chunk=16)
        cases[("nll", n)] = lambda g=g: seq_sharded_nll(p["params"], p["ids"], CFG, g)

    def uneven():
        try:
            seq_sharded_forward(p["params"], p["ids"][:, :30], CFG, groups[4])
        except ValueError as e:
            return str(e)
        return "no raise"

    cases["uneven"] = uneven
    cases["plain_fwd"] = lambda: llama.forward(p["params"], p["ids"], CFG)
    return cases


@pytest.fixture(scope="module")
def refs():
    import jax

    from qtpu.models.config import TINY_TEST as J_TINY
    from qtpu.models.llama import init_params
    from qtpu.sharding.ring_attention import ring_attention as jax_ring
    from qtpu_torch.convert import params_to_torch
    from jax.sharding import Mesh

    rng = np.random.default_rng(0)
    qkv = {t: rng.standard_normal((B, S, H if t == "q" else KV, HD)).astype(np.float32)
           for t in "qkv"}
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    want = {c: np.asarray(jax_ring(*(jax.numpy.asarray(qkv[t]) for t in "qkv"), mesh,
                                   chunk=c)) for c in (None, 8)}
    jp = init_params(J_TINY, jax.random.PRNGKey(0))
    payload = {
        "f32": {t: torch.from_numpy(a) for t, a in qkv.items()},
        "bf16": {t: torch.from_numpy(a).to(torch.bfloat16) for t, a in qkv.items()},
        "params": params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        "ids": torch.from_numpy(rng.integers(0, 512, (2, SEQ_S))).long(),
    }
    return payload, want


@pytest.fixture(scope="module")
def world(tmp_path_factory, refs):
    return run_world(tmp_path_factory, ring_worker, refs[0])


def _plain(q, k, v, window):
    """f32 causal attention with GQA (the softmax of the masked scores)."""
    q, k, v = q.float(), k.float(), v.float()
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    i = torch.arange(q.shape[1])
    mask = i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > i[:, None] - window
    p = torch.softmax(s.masked_fill(~mask, -1e30), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(q.shape[0], q.shape[1], -1)


def _gathered(world, key, n):
    return torch.cat([case(world, key, r).float() for r in range(n)], dim=1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("window", [0, 20])
def test_ring_attention_matches_plain(world, refs, n, dt, tol, chunk, window):
    payload, _ = refs
    want = _plain(*(payload[dt][t] for t in "qkv"), window)
    got = _gathered(world, (n, dt, chunk, window), n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [None, 8])
def test_ring_attention_matches_qtpus(world, refs, chunk):
    _, want = refs
    got = _gathered(world, (4, "f32", chunk, 0), 4)
    np.testing.assert_allclose(got.numpy(), want[chunk].reshape(got.shape), rtol=1e-5, atol=1e-5)


def test_uneven_split_raises(world):
    assert "must divide over seq=4" in case(world, "uneven")


@pytest.mark.parametrize("n", [2, 4])
def test_seq_sharded_forward_and_nll_match_the_plain_forward(world, refs, n):
    import torch.nn.functional as Fn

    payload, _ = refs
    plain = case(world, "plain_fwd")
    got = torch.cat([case(world, ("fwd", n), r) for r in range(n)], dim=1)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-2, atol=2e-2)
    ids = payload["ids"]
    want = Fn.cross_entropy(plain[:, :-1].reshape(-1, plain.shape[-1]), ids[:, 1:].reshape(-1))
    nll = [float(case(world, ("nll", n), r)) for r in range(4)]
    assert len(set(nll)) == 1
    assert abs(nll[0] / float(want) - 1) < 1e-3
