"""The port's GPipe pipeline (qtpu_torch.sharding.pipeline) against the
unsharded port and qtpu's pipeline_nll on the CPU: 1, 2 and 4 stages of a
4-layer tiny-test, packed W4 stages, a 3-axis data 1 x pipe 2 x model 2
mesh, the pipelined perplexity and the runner's pipe mesh config.

One world of 4 gloo processes computes every case (run_world of
tests/test_torch_sharding.py); the parent runs qtpu on the virtual CPU
devices. Tolerances: per-microbatch NLL within 1e-5 relative of the
unsharded port (the stages run the same layers on the same bf16
activations; the 3-axis mesh's tensor-parallel sums are held to qtpu's
pipeline parity bound, 2e-3), and within qtpu's own pipeline parity bound
(rtol = atol = 2e-3, tests/test_pipeline.py) of qtpu's pipeline_nll.
"""

import numpy as np
import pytest
import torch

from qtpu_torch.models import config as tconfig
from test_torch_sharding import case, one_torch_thread, run_world  # noqa: F401  (a fixture)

CFG = tconfig.TINY_TEST.replace(num_layers=4)
M, B, S = 4, 2, 32
RUN = {"model_name": "tiny-test", "quantization_methods": [], "calibration_dataset": "synthetic",
       "test_dataset": "synthetic", "n_calibration_samples": 2, "calibration_block_size": 32,
       "n_test_samples": 4, "test_block_size": 32, "serving": {"benchmark": False},
       "verbose": False}


def _nll(p, params, qmeta, mesh):
    from qtpu_torch.sharding.pipeline import pipeline_nll, shard_params_pipeline

    stage = shard_params_pipeline(params, mesh, cfg=CFG, qmeta=qmeta)
    return pipeline_nll(stage, p["batches"], CFG, mesh, qmeta=qmeta)


def pipeline_worker(rank, world, p):
    from qtpu_torch.bench import QuantizationBenchmark
    from qtpu_torch.eval.perplexity import evaluate_perplexity
    from qtpu_torch.sharding.pipeline import make_pipe_mesh

    meshes = {1: make_pipe_mesh(1, data=4), 2: make_pipe_mesh(2, data=2),
              4: make_pipe_mesh(4, data=1)}
    cases = {f"stages{n}": (lambda n=n: _nll(p, p["params"], None, meshes[n])) for n in meshes}
    cases["packed"] = lambda: _nll(p, p["packed"], p["qmeta"], meshes[2])
    cases["tp"] = lambda: _nll(p, p["params"], None, make_pipe_mesh(2, data=1, model=2))
    cases["ppl"] = lambda: evaluate_perplexity(p["params"], p["stream"], CFG, n_samples=4,
                                               block_size=S, mesh=meshes[2])

    def runner():
        bench = QuantizationBenchmark(dict(RUN, mesh={"data": 2, "pipe": 2}), device="cpu")
        bench.run_all_benchmarks()
        return bench.results["raw"].perplexity, tuple(bench.mesh.mesh_dim_names)

    cases["runner"] = runner
    return cases


@pytest.fixture(scope="module")
def refs():
    from dataclasses import replace

    import jax

    from qtpu.models.config import TINY_TEST as J_TINY
    from qtpu.models.llama import init_params
    from qtpu.sharding.pipeline import make_pipe_mesh, pipeline_nll, shard_params_pipeline
    from qtpu_torch.convert import params_to_numpy, params_to_torch
    from qtpu_torch.data.synthetic import synthetic_token_stream
    from qtpu_torch.quant.apply import pack_model

    jcfg = replace(J_TINY, num_layers=4)
    params = params_to_torch(jax.tree_util.tree_map(
        np.asarray, init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    packed, qmeta = pack_model(params, "rtn", {"w_bit": 4, "q_group_size": 64})
    batches = np.random.default_rng(1).integers(0, 512, (M, B, S)).astype(np.int32)
    mesh = make_pipe_mesh(pipe=2, data=1)
    want = {}
    for name, tree, q in (("raw", params, None), ("packed", packed, qmeta)):
        jt = jax.tree_util.tree_map(jax.numpy.asarray, params_to_numpy(tree))
        sp = shard_params_pipeline(jt, mesh)
        want[name] = np.asarray(pipeline_nll(sp, jax.numpy.asarray(batches), jcfg, mesh, 2,
                                             qmeta=q))
    payload = {"params": params, "packed": packed, "qmeta": qmeta,
               "batches": torch.from_numpy(batches).long(),
               "stream": synthetic_token_stream(512, 4 * S + 1, seed=3)}
    return payload, want


@pytest.fixture(scope="module")
def world(tmp_path_factory, refs):
    return run_world(tmp_path_factory, pipeline_worker, refs[0])


def _unsharded(payload, name, qmeta=None):
    import torch.nn.functional as Fn

    from qtpu_torch.models import llama

    out = []
    for ids in payload["batches"]:
        logits = llama.forward(payload[name], ids, CFG, qmeta=qmeta)
        ce = Fn.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))
        out.append(float(ce) * S)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipeline_nll_matches_unsharded_and_qtpu(world, refs, stages):
    payload, want = refs
    got = [case(world, f"stages{stages}", r).numpy() for r in range(4)]
    for g in got[1:]:  # every stage and data coordinate returns the losses
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], _unsharded(payload, "params"), rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[0], want["raw"], rtol=2e-3, atol=2e-3)


def test_pipeline_nll_packed(world, refs):
    payload, want = refs
    got = case(world, "packed").numpy()
    np.testing.assert_allclose(got, _unsharded(payload, "packed", payload["qmeta"]), rtol=1e-5,
                               atol=0)
    np.testing.assert_allclose(got, want["packed"], rtol=2e-3, atol=2e-3)


def test_pipeline_with_tensor_parallel_stages(world, refs):
    payload, want = refs
    got = case(world, "tp").numpy()
    np.testing.assert_allclose(got, _unsharded(payload, "params"), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want["raw"], rtol=2e-3, atol=2e-3)


def test_pipelined_perplexity_and_runner_equal_serial(world, refs):
    from qtpu_torch.bench import QuantizationBenchmark
    from qtpu_torch.eval.perplexity import evaluate_perplexity

    payload, _ = refs
    serial = evaluate_perplexity(payload["params"], payload["stream"], CFG, n_samples=4,
                                 block_size=S)
    assert abs(case(world, "ppl") / serial - 1) < 1e-5
    ppl, dims = case(world, "runner")
    assert dims == ("data", "pipe")
    bench = QuantizationBenchmark(dict(RUN), device="cpu")
    bench.run_all_benchmarks()
    assert abs(ppl / bench.results["raw"].perplexity - 1) < 1e-5


def test_pipeline_on_gpt2_raises():
    from qtpu_torch.sharding.pipeline import pipeline_nll, shard_params_pipeline

    with pytest.raises(NotImplementedError, match="llama family"):
        shard_params_pipeline({}, None, arch="gpt2")
    with pytest.raises(NotImplementedError, match="llama family"):
        pipeline_nll({}, torch.zeros(1, 1, 4), tconfig.TINY_GPT2_TEST, None, arch="gpt2")
