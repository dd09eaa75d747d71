"""qtpu_torch.bench.extra (the port of bench_extra.py) on the CPU: its
measurements run at small shapes on TINY_TEST and TINY_MOE_TEST, two
blocks each, and their tokens are held to qtpu's on the same packed bytes
(qtpu_torch.bench.synth's weights moved through numpy): decode_tps's first decode
block against qtpu's prefill and decode steps (plain, and with the prompt
written at an offset into the per-layer cache), each token a top logit
of qtpu's up to a near-tie, prefill_tps's argmax
against qtpu's forward. The batcher's requests are held to the port's own
greedy_generate on each prompt: qtpu's engine compiles a program for every
(batch, chunk) bucket it meets, minutes on the CPU. QTPU_MOE_GATHERED=0
sends a one-sequence MoE decode to the grouped route; main writes every key
of bench_extra.py and keeps the keys it finds."""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.models import llama as jllama
from qtpu.models.config import TINY_MOE_TEST as J_MOE
from qtpu.models.config import TINY_TEST as J_TINY
from qtpu.serve import init_cache as jinit_cache
from qtpu.serve.decode import decode_step as jdecode_step
from qtpu.serve.decode import prefill as jprefill
from qtpu_torch.bench import extra, synth
from qtpu_torch.convert import params_to_numpy
from qtpu_torch.models import moe
from qtpu_torch.models.config import TINY_MOE_TEST, TINY_TEST
from qtpu_torch.serve import decode
from test_torch_quant import one_torch_thread  # noqa: F401  (a fixture)

LOGIT_TOL = 2e-2  # relative Frobenius error of the f32 logits (tests/test_torch_moe.py)
GAP = 5e-2  # tokens compared where qtpu's top-2 logit gap exceeds this
P, BLOCK = 16, 4


@pytest.fixture(scope="module")
def models():
    """The port's synthetic packed models (qtpu's shapes and qmeta,
    tests/test_torch_synth.py) and the same bytes as jax arrays."""
    out = {}
    for name, make, cfg, jcfg in (("llama", synth.tiled_packed_llama, TINY_TEST, J_TINY),
                                  ("moe", synth.tiled_packed_moe, TINY_MOE_TEST, J_MOE)):
        tp, qmeta = make(cfg, device="cpu")
        tp = jax.tree_util.tree_map(lambda t: t.contiguous(), tp)  # the tiled views, whole
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp))
        out[name] = (jp, tp, qmeta, cfg, jcfg)
    return out


def _qtpu_block_logits(jp, qmeta, jcfg, prompt, toks, S, arch, cache_pad=0, per_layer=False):
    """qtpu's decode_tps run up to its first block, teacher-forced on the
    port's tokens toks [B, 1 + BLOCK] (the prefill's, then the block's): the
    prefill at cache_pad, then BLOCK decode steps. Returns the logits each
    token was drawn from, [B, 1 + BLOCK, V]."""
    B = prompt.shape[0]
    cache = jinit_cache(jcfg, B, S, quantized=True, per_layer=per_layer)
    start = jnp.full((B,), cache_pad, jnp.int32) if cache_pad else None
    logits, cache = jprefill(jp, jnp.asarray(prompt), cache, jcfg, qmeta, start=start, arch=arch)
    outs = [np.asarray(logits)]
    for i in range(BLOCK):
        pos = jnp.full((B,), cache_pad + P + i, jnp.int32)
        logits, cache = jdecode_step(jp, jnp.asarray(toks[:, i]), pos, cache, jcfg, qmeta,
                                     arch=arch)
        outs.append(np.asarray(logits))
    return np.stack(outs, 1)


@pytest.mark.parametrize("name,B,cache_pad,per_layer", [
    ("llama", 2, 0, False), ("llama", 2, 1024, True), ("moe", 2, 0, False), ("moe", 1, 0, False)])
def test_decode_tps_first_block_equals_qtpu(models, name, B, cache_pad, per_layer):
    """decode_tps (2 blocks of 4 against 1) records the prefill's token and
    its first block's greedy tokens; qtpu's prefill and decode steps on the
    same bytes, fed the same tokens, give each of them a logit within GAP
    of their largest (a bf16 near-tie may break either way under other sum
    orders), so where qtpu's top-2 gap exceeds GAP the tokens are equal. The
    per-layer case: S rounded up to 2048, K12's plain version against
    qtpu's flash decode kernel in interpret mode."""
    jp, tp, qmeta, cfg, jcfg = models[name]
    rec = {}
    tps = extra.decode_tps(tp, qmeta, cfg, B=B, P=P, n_small=1, n_large=2, block=BLOCK,
                           arch=cfg.arch, cache_pad=cache_pad, per_layer=per_layer,
                           device="cpu", record=rec)
    got = torch.cat([rec["prefill_token"][:, None], rec["first_block"]], 1).numpy()
    assert tps > 0 and got.shape == (B, 1 + BLOCK)
    S = cache_pad + P + 2 * BLOCK + 8
    S += (-S) % 2048 if per_layer else 0
    want = _qtpu_block_logits(jp, qmeta, jcfg, rec["prompt"].numpy(), got, S, cfg.arch,
                              cache_pad, per_layer)
    _near_ties_only(got, want)


def _near_ties_only(got, want):
    """Each token of got [...] a logit of want [..., V] within GAP of the
    row's largest; equal to want's argmax where the top-2 gap exceeds GAP."""
    picked = np.take_along_axis(want, got[..., None].astype(np.int64), -1)[..., 0]
    assert (picked >= want.max(-1) - GAP).all(), (got, want.argmax(-1))
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    np.testing.assert_array_equal(got[clear], want.argmax(-1)[clear])


def test_prefill_tps_argmax_equals_qtpu(models):
    """prefill_tps's first forward: its argmax picks qtpu's forward's on
    the same bytes up to near-ties."""
    jp, tp, qmeta, cfg, jcfg = models["llama"]
    rec = {}
    assert extra.prefill_tps(tp, qmeta, cfg, B=2, S=64, iters=1, device="cpu", record=rec) > 0
    logits = np.asarray(jllama.forward(jp, jnp.asarray(rec["ids"].numpy()), jcfg, qmeta=qmeta))
    _near_ties_only(rec["argmax"].numpy(), logits)


@pytest.mark.parametrize("name", ["llama", "moe"])
def test_batcher_load_answers_as_greedy_generate(models, name):
    """The cold and warm engines of batcher_load answer every request with
    new_tokens tokens, each the port's greedy_generate on its prompt."""
    from qtpu_torch.serve.kvcache import init_cache

    _, tp, qmeta, cfg, _ = models[name]
    plan = extra.Plan.tiny()
    rec = {}
    keys = extra.batcher_load(tp, qmeta, cfg, plan, device="cpu", record=rec)
    assert keys["batcher_requests"] == plan.requests and keys["batcher_tokens_per_s"] > 0
    for eng in ("warm", "cold"):
        done = sorted(rec[eng], key=lambda r: r.uid)
        assert len(done) == plan.requests
        for r in done:
            prompt = torch.from_numpy(r.prompt[None].astype(np.int64))
            cache = init_cache(cfg, 1, len(r.prompt) + plan.new_tokens + 8, quantized=True,
                               device="cpu")
            want, _ = decode.greedy_generate(tp, prompt, cache, cfg, plan.new_tokens, qmeta,
                                             arch=cfg.arch)
            assert r.output == want[0].tolist(), (eng, r.uid)


def test_moe_gathered_off_takes_the_grouped_route(models, monkeypatch):
    """QTPU_MOE_GATHERED=0 (qtpu's switch, default "1") sends a B 1 decode
    step to the grouped route (K9's plain version, no K10 call); its logits
    equal the gathered route's within the logit tolerance."""
    _, tp, qmeta, cfg, _ = models["moe"]
    calls = {"gathered": 0, "grouped": 0}
    real_g, real_e = moe.moe_gathered_matmul, moe.moe_matmul

    def spy_g(*a, **k):
        calls["gathered"] += 1
        return real_g(*a, **k)

    def spy_e(*a, **k):
        calls["grouped"] += 1
        return real_e(*a, **k)

    monkeypatch.setattr(moe, "moe_gathered_matmul", spy_g)
    monkeypatch.setattr(moe, "moe_matmul", spy_e)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, P)))

    def step(flag):
        from qtpu_torch.serve.kvcache import init_cache

        monkeypatch.setenv("QTPU_MOE_GATHERED", flag)
        cache = init_cache(cfg, 1, 32, quantized=True, device="cpu")
        decode.prefill(tp, ids, cache, cfg, qmeta, arch="moe")
        for k in calls:
            calls[k] = 0
        logits, _ = decode.decode_step(tp, ids[:, -1].to(torch.int32),
                                       torch.tensor([P], dtype=torch.int32), cache, cfg, qmeta,
                                       arch="moe")
        return logits.numpy(), dict(calls)

    gathered, c1 = step("1")
    grouped, c0 = step("0")
    L = cfg.num_layers
    assert c1 == {"gathered": 3 * L, "grouped": 0}
    assert c0 == {"gathered": 0, "grouped": 3 * L}
    rel = np.linalg.norm(grouped - gathered) / np.linalg.norm(gathered)
    assert rel < LOGIT_TOL, rel


def _qtpu_keys():
    src = (Path(__file__).resolve().parents[1] / "bench_extra.py").read_text()
    return set(re.findall(r'out\["([a-z0-9_]+)"\]', src)) | set(
        re.findall(r'\(\d, "(moe_[a-z0-9_]+)"\)', src))


def test_main_writes_every_qtpu_key_and_keeps_found_ones(tmp_path, monkeypatch, capsys):
    want = _qtpu_keys()
    assert len(want) == 16
    out = tmp_path / "extra.json"
    assert extra.main(["--out", str(out), "--device", "cpu", "--tiny"]) == 0
    got = json.loads(out.read_text())
    assert set(got) == want and all(v > 0 for v in got.values())
    # a second run measures nothing: every key is kept
    monkeypatch.setattr(extra, "decode_tps", lambda *a, **k: pytest.fail("measured again"))
    assert extra.main(["--out", str(out), "--device", "cpu", "--tiny"]) == 0
    assert json.loads(out.read_text()) == got
    assert capsys.readouterr().out.count('"cached": true') == 11


def test_main_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert extra.main(["--out", str(tmp_path / "x.json")]) == 2
    assert not (tmp_path / "x.json").exists()
