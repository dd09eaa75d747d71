"""The port's tensor and data parallelism against qtpu's on the CPU: the
('data', 'model') mesh, qtpu's per-leaf specs, shard_params (fused sites
split per member, packed row-parallel sites at group boundaries, the
raises), the TP/DP forward of llama, GPT-2 and OPT (raw, packed, GPTQ
actorder), TP/DP prefill and decode, sharded perplexity, the runner's mesh
config, MoE expert parallelism, and tp 4 over 2 KV heads (each rank holds
the KV head its q heads read) on TINY_TEST, a 4-layer model of TinyLlama's
8 q heads a KV head and TINY_MOE_TEST with its experts split beside.

One world of 4 gloo processes (data 2 x model 2, spawned once for the
module, `init_method` a file under tmp_path) computes every case; each case
is a test of its own. The children import no jax: the parent runs qtpu on
the conftest's 8 virtual CPU devices and hands them numpy-made inputs
through a file. `run_world` and `case` are shared with the other sharding
test files.

Tolerances (qtpu's own tests/test_sharding.py bounds): logits within
rtol = atol = 2e-2 for llama, 3e-2 for GPT-2 / OPT and MoE EP, against
qtpu's sharded forward and the port's unsharded one; greedy tokens equal
where the top-2 gap exceeds 5e-2; DP perplexity within 1e-5 relative of
the serial one.
"""

import dataclasses
import functools
import traceback

import numpy as np
import pytest
import torch

from qtpu_torch.models import get_arch
from qtpu_torch.models import config as tconfig
from qtpu_torch.sharding.multihost import spawn

WORLD = 4
GAP = 5e-2  # greedy tokens compared where the top-2 logit gap exceeds this


# ------------------------------------------------------------ the worlds
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread in the test process, as in the spawned ranks:
    beside parallel test workers and the ranks, threads that spin waiting
    for each other slow every process on the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _child(rank, world, worker, d):
    torch.set_num_threads(1)
    payload = torch.load(f"{d}/payload.pt", weights_only=False)
    out = {}
    for name, fn in worker(rank, world, payload).items():
        try:
            out[name] = fn()
        except Exception:  # recorded, so each case fails on its own
            out[name] = {"error": traceback.format_exc()}
    torch.save(out, f"{d}/rank{rank}.pt")


def run_world(tmp_path_factory, worker, payload, n=WORLD):
    """worker(rank, world, payload) -> {case: thunk}, run in n spawned gloo
    processes; returns each rank's {case: result}."""
    d = tmp_path_factory.mktemp(worker.__name__)
    torch.save(payload, d / "payload.pt")
    spawn(_child, n, (worker, str(d)), init_file=str(d / "init"), timeout_s=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(n)]


def case(results, name, rank=0):
    r = results[rank][name]
    assert not (isinstance(r, dict) and "error" in r), r.get("error") if isinstance(r, dict) else r
    return r


def rows(results, name, ranks=(0, 2)):
    """The data ranks' local rows (model coordinate 0), concatenated."""
    return np.concatenate([np.asarray(case(results, name, r)) for r in ranks], axis=0)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------- the children
def _tp_forward(params, qmeta, cfg, mesh, ids):
    from qtpu_torch.sharding.mesh import axis_rank, axis_size, local_group
    from qtpu_torch.sharding.specs import shard_model

    dp, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
    B = ids.shape[0] // dp
    lp, lq, lc = shard_model(params, qmeta, cfg, mesh)
    return get_arch(cfg.arch).forward(lp, ids[d * B:(d + 1) * B], lc, qmeta=lq,
                                      tp=local_group(mesh, "model"))


def _tp_decode(params, qmeta, cfg, mesh, prompt, steps=3):
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding.mesh import axis_rank, axis_size, local_group
    from qtpu_torch.sharding.specs import shard_model

    dp, d = axis_size(mesh, "data"), axis_rank(mesh, "data")
    B = prompt.shape[0] // dp
    prompt = prompt[d * B:(d + 1) * B]
    tp = local_group(mesh, "model")
    lp, lq, lc = shard_model(params, qmeta, cfg, mesh)
    cache = init_cache(lc, B, 32, quantized=True, device="cpu")
    logits, cache = prefill(lp, prompt, cache, lc, lq, arch=cfg.arch, tp=tp)
    outs = [logits]
    tok = torch.argmax(logits, -1).to(torch.int32)
    pos = torch.full((B,), prompt.shape[1], dtype=torch.int32)
    for _ in range(steps):
        logits, cache = decode_step(lp, tok, pos, cache, lc, lq, arch=cfg.arch, tp=tp)
        outs.append(logits)
        tok = torch.argmax(logits, -1).to(torch.int32)
        pos = pos + 1
    return {"logits": torch.stack(outs, 1), "kv_shape": tuple(cache.k.shape)}


def _mesh_cases():
    from qtpu_torch.sharding.mesh import make_mesh

    m = make_mesh(data=2, model=2)
    m2 = make_mesh(model=2)
    m4 = make_mesh(data=-1, model=4)
    out = {"2x2": (m.size(0), m.size(1)), "model2": (m2.size(0), m2.size(1)),
           "model4": (m4.size(0), m4.size(1))}
    try:
        make_mesh(data=3, model=2)
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def _boundary_raises(p):
    import os

    from qtpu_torch.serve.decode import decode_step
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.specs import shard_model

    mesh = make_mesh(data=2, model=2)
    lp, lq, lc = shard_model(p["llama_fused"], p["fused_qmeta"], p["cfgs"]["llama"], mesh)
    cache = init_cache(lc, 2, 32, quantized=True, device="cpu")
    os.environ["QTPU_BOUNDARY"] = "1"
    try:
        decode_step(lp, torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                    cache, lc, lq, tp=local_group(mesh, "model"))
    except ValueError as e:
        return str(e)
    finally:
        del os.environ["QTPU_BOUNDARY"]
    return "no raise"


def _ppl(p, mesh_shape):
    from qtpu_torch.eval.perplexity import evaluate_perplexity
    from qtpu_torch.sharding.mesh import make_mesh

    mesh = make_mesh(*mesh_shape)
    return evaluate_perplexity(p["llama_packed"], p["stream"], p["cfgs"]["llama"], n_samples=6,
                               block_size=64, qmeta=p["packed_qmeta"], mesh=mesh)


def _runner(p):
    from qtpu_torch.bench import QuantizationBenchmark

    bench = QuantizationBenchmark(dict(p["run_config"], mesh={"data": 2, "model": 2}),
                                  device="cpu")
    bench.run_all_benchmarks()
    return {k: v.to_dict() for k, v in bench.results.items()}, bench.mesh is not None


def _moe_routes(p):
    """The expert MLP of layer 0 on the same h, sharded over the experts,
    against the unsharded one: the grouped route (B 4, T 8 and T 1) and the
    gathered one (B 1, T 1)."""
    from qtpu_torch.models import moe
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.specs import shard_model

    mesh = make_mesh(data=2, model=2)
    cfg, packed, qmeta = p["cfgs"]["moe"], p["moe_packed"], p["moe_qmeta"]
    lp, lq, lc = shard_model(packed, qmeta, cfg, mesh)
    tp = local_group(mesh, "model")
    g = torch.Generator().manual_seed(5)
    out = {}
    for B, T in ((4, 8), (4, 1), (1, 1)):
        h = (torch.randn(B, T, cfg.hidden_size, generator=g) * 0.5).to(torch.bfloat16)
        want = moe._moe_mlp(h, packed["layers"], cfg, dict(qmeta).get, 0)
        got = moe._moe_mlp(h, lp["layers"], lc, dict(lq).get, 0, tp=tp)
        out[(B, T)] = (got.float(), want.float(),
                       moe._gathered_route(packed["layers"], cfg, dict(qmeta).get, B, T))
    return out


# tp 4 over 2 KV heads: (payload params, its qmeta or None, cfg key)
TP4 = {"llama": ("llama", None, "llama"), "llama_fused": ("llama_fused", "fused_qmeta", "llama"),
       "tl": ("tl", None, "tl"), "tl_fused": ("tl_fused", "tl_qmeta", "tl"),
       "moe": ("moe", None, "moe"), "moe_packed": ("moe_packed32", "moe_qmeta32", "moe")}
TP4_DECODE = ("llama_fused", "tl_fused", "moe_packed")
TP4_ROWS = 4  # the batch of the tp 4 runs


def _tp4_cases(p, cases):
    from qtpu_torch.sharding.mesh import make_mesh

    mesh4 = make_mesh(data=1, model=4)
    ids = p["ids"][:TP4_ROWS]
    for key, (name, qname, ckey) in TP4.items():
        args = (p[name], p[qname] if qname else None, p["cfgs"][ckey], mesh4)
        cases[f"tp4_fwd_{key}"] = lambda a=args: _tp_forward(*a, ids)
        if key in TP4_DECODE:
            cases[f"tp4_decode_{key}"] = lambda a=args: _tp_decode(*a, ids[:, :16])


# uneven splits (whole heads, KV groups and quantization groups in parts
# that need not be equal): key -> (payload params, its qmeta or None, cfg
# key, tp). kv3: H 6 / KV 3 at tp 2 (KV 2 + 1, q 4 + 2); kv2: H 6 / KV 2 at
# tp 4 (q 2, 1, 2, 1); h2: H 2 / KV 1 at tp 4 (two ranks hold no head);
# opt6: OPT at H 6, tp 4; gather: H 6 / KV 2 / I 384 at W4 g128, tp 2 (the
# heads cut o_proj's 3 groups: the attention output gathered; down_proj's 3
# groups 2 + 1); w8a8: SmoothQuant W8A8 on TINY_TEST, its row-parallel
# sites on the all-reduced per-token absmax; gptq_perm: GPTQ actorder with
# one perm over all of K (actorder_shards 1), which crosses the ranks' rows
# (their row-parallel sites gather their input, as qtpu's GSPMD does)
UNEVEN = {"kv3_raw": ("kv3", None, "kv3", 2), "kv3_w4": ("kv3_w4", "kv3_qmeta", "kv3", 2),
          "kv2_tp4": ("kv2", None, "kv2", 4), "h2_tp4": ("h2", None, "h2", 4),
          "opt6_tp4": ("opt6", None, "opt6", 4),
          "gather_w4": ("gather_w4", "gather_qmeta", "gather", 2),
          "w8a8_tp2": ("llama_w8a8", "w8a8_qmeta", "llama", 2),
          "w8a8_tp4": ("llama_w8a8", "w8a8_qmeta", "llama", 4),
          "gptq_perm_tp2": ("llama_perm", "perm_qmeta", "llama", 2)}
UNEVEN_DECODE = {"kv3_w4": ("kv3_fused", "kv3_fqmeta", "kv3", 2),
                 "gather_w4": ("gather_fused", "gather_fqmeta", "gather", 2),
                 "w8a8_tp2": ("llama_w8a8", "w8a8_qmeta", "llama", 2)}


def _uneven_cases(p, cases):
    from qtpu_torch.sharding.mesh import make_mesh

    meshes = {tp: make_mesh(data=WORLD // tp, model=tp) for tp in (2, 4)}
    ids = p["ids"][:TP4_ROWS]
    for key, (name, qname, ckey, tp) in UNEVEN.items():
        args = (p[name], p[qname] if qname else None, p["cfgs"][ckey], meshes[tp])
        cases[f"uneven_fwd_{key}"] = lambda a=args: _tp_forward(*a, ids)
    for key, (name, qname, ckey, tp) in UNEVEN_DECODE.items():
        args = (p[name], p[qname], p["cfgs"][ckey], meshes[tp])
        cases[f"uneven_decode_{key}"] = lambda a=args: _tp_decode(*a, ids[:, :16])


def sharding_worker(rank, world, p):
    from qtpu_torch.sharding.mesh import make_mesh

    cfgs, ids = p["cfgs"], p["ids"]
    mesh = make_mesh(data=2, model=2)
    cases = {"mesh": _mesh_cases}
    for arch in ("llama", "gpt2", "opt"):
        cases[f"fwd_{arch}"] = (lambda a=arch: _tp_forward(p[a], None, cfgs[a], mesh, ids))
    cases["fwd_packed"] = lambda: _tp_forward(p["llama_packed"], p["packed_qmeta"],
                                              cfgs["llama"], mesh, ids)
    cases["fwd_actorder"] = lambda: _tp_forward(p["llama_actorder"], p["actorder_qmeta"],
                                                cfgs["llama"], mesh, ids)
    cases["decode"] = lambda: _tp_decode(p["llama_fused"], p["fused_qmeta"], cfgs["llama"],
                                         mesh, ids[:4, :16])
    cases["decode_opt"] = lambda: _tp_decode(p["opt_fused"], p["opt_qmeta"], cfgs["opt"],
                                             mesh, ids[:4, :16])
    cases["boundary"] = lambda: _boundary_raises(p)
    cases["ppl_dp"] = lambda: _ppl(p, (4, 1))
    cases["ppl_tp"] = lambda: _ppl(p, (2, 2))
    cases["fwd_moe"] = lambda: _tp_forward(p["moe"], None, cfgs["moe"], mesh, ids)
    cases["moe_routes"] = lambda: _moe_routes(p)
    cases["runner"] = lambda: _runner(p)
    _tp4_cases(p, cases)
    _uneven_cases(p, cases)
    return cases


# ------------------------------------------------------------ the parent
RUN_CONFIG = {
    "model_name": "tiny-test",
    "quantization_methods": ["rtn", "awq"],
    "quantization_config": {"rtn": {"w_bit": 4, "q_group_size": 64},
                            "awq": {"w_bit": 4, "q_group_size": 64}},
    "calibration_dataset": "synthetic", "test_dataset": "synthetic",
    "n_calibration_samples": 4, "calibration_block_size": 32,
    "n_test_samples": 4, "test_block_size": 64, "packed_eval": True,
    "serving": {"benchmark": True, "max_batch_size": 4}, "verbose": False,
}


# a 4-layer model of TinyLlama-1.1B's 8 q heads a KV head, narrow
TL_SHAPED = {"num_heads": 16, "num_kv_heads": 2, "head_dim": 16, "num_layers": 4}


def _jax_params(arch, jcfg, key, dtype=None):
    import jax

    from qtpu.models import get_arch as jget

    kw = {} if dtype is None else {"dtype": dtype}
    p = jget(arch).init_params(jcfg, jax.random.PRNGKey(key), **kw)
    return p, jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def qtpu_refs():
    """qtpu's params and sharded results (data 2 x model 2 on the virtual
    CPU devices) and the port's inputs: the packed bytes are the port's
    (pack_model, fuse_packed_sites; RTN equals qtpu's bit for bit,
    tests/test_torch_eval.py), fed to both packages through numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qtpu.models import config as jconfig
    from qtpu.models import get_arch as jget
    from qtpu.serve import init_cache
    from qtpu.serve.decode import decode_step, prefill
    from qtpu.sharding import make_mesh, shard_params
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.convert import params_to_numpy, params_to_torch
    from qtpu_torch.data.synthetic import synthetic_token_stream
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    jcfgs = {"llama": jconfig.TINY_TEST, "gpt2": jconfig.TINY_GPT2_TEST,
             "opt": jconfig.TINY_OPT_TEST, "moe": jconfig.TINY_MOE_TEST,
             "tl": dataclasses.replace(jconfig.TINY_TEST, **TL_SHAPED)}
    cfgs = {"llama": tconfig.TINY_TEST, "gpt2": tconfig.TINY_GPT2_TEST,
            "opt": tconfig.TINY_OPT_TEST, "moe": tconfig.TINY_MOE_TEST,
            "tl": tconfig.TINY_TEST.replace(**TL_SHAPED)}
    mesh = make_mesh(data=2, model=2)
    ids = np.random.default_rng(1).integers(0, 512, (8, 64)).astype(np.int32)
    jids = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("data", None)))
    payload = {"cfgs": cfgs, "ids": torch.from_numpy(ids).long(), "run_config": RUN_CONFIG}
    want = {}

    def to_jax(tree):
        return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tree))

    def sharded(arch, tree, qmeta=None):
        sp = shard_params(to_jax(tree), mesh, arch=arch)
        with jax.sharding.set_mesh(mesh):
            return np.asarray(jget(arch).forward(sp, jids, jcfgs[arch], qmeta=qmeta))

    for arch in ("llama", "gpt2", "opt"):
        payload[arch] = params_to_torch(_jax_params(arch, jcfgs[arch], 0)[1], device="cpu")
        want[f"fwd_{arch}"] = sharded(arch, payload[arch])
    # f32: in bf16 a near-tied router may pick another expert under other sum orders
    payload["moe"] = params_to_torch(_jax_params("moe", jcfgs["moe"], 0, jnp.float32)[1], "cpu")
    want["fwd_moe"] = sharded("moe", payload["moe"])
    moe_bf16 = params_to_torch(_jax_params("moe", jcfgs["moe"], 3)[1], "cpu")
    payload["moe_packed"], payload["moe_qmeta"] = pack_model(
        moe_bf16, "rtn", {"w_bit": 4, "q_group_size": 64}, arch="moe")

    llama = payload["llama"]
    rtn = {"w_bit": 4, "q_group_size": 64}
    payload["llama_packed"], payload["packed_qmeta"] = pack_model(llama, "rtn", rtn)
    want["fwd_packed"] = sharded("llama", payload["llama_packed"], payload["packed_qmeta"])
    calib = [np.random.default_rng(40 + i).integers(0, 512, (1, 32)) for i in range(2)]
    stats = collect_calibration_stats(get_arch("llama").forward, llama, calib, cfgs["llama"])
    payload["llama_actorder"], payload["actorder_qmeta"] = pack_model(
        llama, "gptq", {**rtn, "actorder": True, "actorder_shards": 2, "nsamples": 8}, stats)
    want["fwd_actorder"] = sharded("llama", payload["llama_actorder"], payload["actorder_qmeta"])

    for arch, name, qname in (("llama", "llama_fused", "fused_qmeta"),
                              ("opt", "opt_fused", "opt_qmeta")):
        fp, fq = fuse_packed_sites(*pack_model(payload[arch], "rtn", rtn, arch=arch), arch=arch)
        payload[name], payload[qname] = fp, fq
        sp = shard_params(to_jax(fp), mesh, arch=arch)
        prompt = jnp.asarray(ids[:4, :16])
        with jax.sharding.set_mesh(mesh):
            cache = init_cache(jcfgs[arch], 4, 32)
            logits, cache = prefill(sp, prompt, cache, jcfgs[arch], qmeta=fq, arch=arch)
            outs = [np.asarray(logits)]
            tok = jnp.argmax(logits, axis=-1)
            pos = jnp.full((4,), 16, jnp.int32)
            for _ in range(3):
                logits, cache = decode_step(sp, tok, pos, cache, jcfgs[arch], qmeta=fq,
                                            arch=arch)
                outs.append(np.asarray(logits))
                tok = jnp.argmax(logits, axis=-1)
                pos = pos + 1
        want["decode" if arch == "llama" else "decode_opt"] = np.stack(outs, 1)
    payload["stream"] = synthetic_token_stream(512, 6 * 64 + 3, seed=7)

    # tp 4 over 2 KV heads: qtpu's GSPMD splits kv_dim in four and reshards
    payload["tl"] = params_to_torch(_jax_params("llama", jcfgs["tl"], 4)[1], device="cpu")
    payload["tl_fused"], payload["tl_qmeta"] = fuse_packed_sites(
        *pack_model(payload["tl"], "rtn", rtn))
    # packed from the f32 MoE params: a bf16 router's near-ties flip routes
    # under other sum orders (as for payload["moe"] above)
    payload["moe_packed32"], payload["moe_qmeta32"] = pack_model(payload["moe"], "rtn", rtn,
                                                                 arch="moe")
    mesh4 = make_mesh(data=1, model=4, devices=jax.devices()[:4])
    ids4 = jax.device_put(jnp.asarray(ids[:TP4_ROWS]), NamedSharding(mesh4, P(None, None)))
    for key, (name, qname, ckey) in TP4.items():
        arch = cfgs[ckey].arch
        sp = shard_params(to_jax(payload[name]), mesh4, arch=arch)
        with jax.sharding.set_mesh(mesh4):
            want[f"tp4_fwd_{key}"] = np.asarray(jget(arch).forward(
                sp, ids4, jcfgs[ckey], qmeta=payload[qname] if qname else None))
    _uneven_refs(payload, want, jcfgs, {2: (mesh, ids[:TP4_ROWS]), 4: (mesh4, ids[:TP4_ROWS])},
                 calib)
    return payload, want


UNEVEN_SHAPES = {"kv3": ("llama", {"num_heads": 6, "num_kv_heads": 3}),
                 "kv2": ("llama", {"num_heads": 6, "num_kv_heads": 2}),
                 "h2": ("llama", {"num_heads": 2, "num_kv_heads": 1}),
                 "gather": ("llama", {"num_heads": 6, "num_kv_heads": 2,
                                      "intermediate_size": 384}),
                 "opt6": ("opt", {"num_heads": 6, "num_kv_heads": 6, "hidden_size": 384})}
W8A8 = {"w_bit": 8, "q_group_size": 128, "alpha": 0.5, "act_quant": True}
# the packed trees: (params, qmeta) name -> (dense params, method, config,
# whether qtpu's reference packs under the mesh: its shard_params refuses
# these packed trees, whose K groups tp does not divide)
UNEVEN_PACKED = {("kv3_w4", "kv3_qmeta"): ("kv3", "rtn", {"w_bit": 4, "q_group_size": 64},
                                           False),
                 ("gather_w4", "gather_qmeta"): ("gather", "rtn",
                                                 {"w_bit": 4, "q_group_size": 128}, True),
                 ("llama_w8a8", "w8a8_qmeta"): ("llama", "smoothquant", W8A8, True),
                 ("llama_perm", "perm_qmeta"): ("llama", "gptq",
                                                {"w_bit": 4, "q_group_size": 64,
                                                 "actorder": True, "nsamples": 8}, False)}


def _to_jax(tree):
    import jax
    import jax.numpy as jnp

    from qtpu_torch.convert import params_to_numpy

    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tree))


def _uneven_refs(payload, want, jcfgs, meshes, calib):
    """The uneven cases' params (the port's packing, fused for decode) and
    qtpu's results by its bench path: shard_params of the dense tree, then
    pack_model under the mesh, then the forward. RTN g64 (kv3_w4), whose
    groups tp divides, runs qtpu's sharded forward on the port's packed
    bytes instead, as the cases above do (RTN packs bit for bit alike,
    tests/test_torch_eval.py): qtpu's pack takes about 9 s a model."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qtpu.calib.stats import collect_calibration_stats as jcollect
    from qtpu.models import config as jconfig
    from qtpu.models import get_arch as jget
    from qtpu.quant.apply import pack_model as jpack
    from qtpu.sharding import shard_params
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.convert import params_to_torch
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model

    cfgs = payload["cfgs"]
    base = {"llama": (jconfig.TINY_TEST, tconfig.TINY_TEST),
            "opt": (jconfig.TINY_OPT_TEST, tconfig.TINY_OPT_TEST)}
    for i, (key, (arch, kw)) in enumerate(UNEVEN_SHAPES.items()):
        jcfgs[key] = dataclasses.replace(base[arch][0], **kw)
        cfgs[key] = base[arch][1].replace(**kw)
        payload[key] = get_arch(arch).init_params(cfgs[key], seed=10 + i, device="cpu")
    # SmoothQuant's statistics, each package's own
    stats = collect_calibration_stats(get_arch("llama").forward, payload["llama"], calib,
                                      cfgs["llama"])
    jstats = jcollect(jget("llama").forward, _to_jax(payload["llama"]), calib, jcfgs["llama"])
    recipe = {}
    for (name, qname), (dkey, method, mcfg, bench) in UNEVEN_PACKED.items():
        st = stats if method in ("smoothquant", "gptq") else None
        payload[name], payload[qname] = pack_model(payload[dkey], method, mcfg, st)
        if bench:
            recipe[name] = (dkey, method, mcfg, jstats if st is not None else None)
        if method == "rtn":
            fname, fq = name.replace("_w4", "_fused"), qname.replace("_qmeta", "_fqmeta")
            payload[fname], payload[fq] = fuse_packed_sites(payload[name], payload[qname])
    for key, (name, qname, ckey, tp) in UNEVEN.items():
        arch = cfgs[ckey].arch
        mesh, ids = meshes[tp]
        spec = P("data", None) if tp == 2 else P(None, None)
        jids = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, spec))
        dkey, method, mcfg, jst = recipe.get(name, (name, None, None, None))
        sp = shard_params(_to_jax(payload[dkey]), mesh, arch=arch)
        with jax.sharding.set_mesh(mesh):
            qmeta = payload[qname] if qname else None
            if method is not None:
                sp, qmeta = jpack(sp, method, mcfg, jst, arch=arch)
            want[f"uneven_fwd_{key}"] = np.asarray(jget(arch).forward(sp, jids, jcfgs[ckey],
                                                                       qmeta=qmeta))


@pytest.fixture(scope="module")
def world(tmp_path_factory, qtpu_refs):
    payload, _ = qtpu_refs
    return run_world(tmp_path_factory, sharding_worker, payload)


def _port(payload, arch, name=None, qmeta=None):
    cfg = payload["cfgs"][arch]
    return get_arch(cfg.arch).forward(payload[name or arch], payload["ids"], cfg,
                                      qmeta=qmeta).numpy()


# ------------------------------------------------------------ the tests
def test_mesh_shapes_and_a_mesh_larger_than_the_world(world):
    got = case(world, "mesh")
    assert got["2x2"] == (2, 2) and got["model2"] == (2, 2) and got["model4"] == (1, 4)
    assert "needs 6 devices, have 4" in got["too_big"]


def test_mesh_larger_than_a_one_process_world_raises():
    from qtpu_torch.sharding.mesh import make_mesh

    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(data=2, model=1)


@pytest.mark.parametrize("arch", ["llama", "moe", "gpt2", "opt"])
def test_param_specs_equal_qtpus(qtpu_refs, arch):
    """The table shard_params applies is qtpu's but for the port's two
    departures: the embedding whole, a row-parallel actorder perm split
    with K."""
    import jax

    from qtpu.sharding.specs import param_specs as jax_specs
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.sharding.specs import param_specs

    payload, _ = qtpu_refs
    cfg = payload["cfgs"][arch]
    trees = [payload[arch]]
    if arch != "gpt2":
        trees.append(pack_model(payload[arch], "rtn", {"w_bit": 4, "q_group_size": 64},
                                arch=arch)[0])
    if arch == "llama":
        trees.append(payload["llama_actorder"])
    row_sites = get_arch(arch).ROW_PARALLEL_SITES
    for tree in trees:
        npt = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, np.float32), tree)
        want = jax.tree_util.tree_map(tuple, jax_specs(npt, arch),
                                      is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        want["embed"] = (None, None)
        for site in row_sites:
            if "perm" in want["layers"].get(site, {}):
                want["layers"][site]["perm"] = (None, "model")
        got = param_specs(tree, arch)
        flat_w = jax.tree_util.tree_leaves(want, is_leaf=lambda s: isinstance(s, tuple))
        flat_g = jax.tree_util.tree_leaves(got, is_leaf=lambda s: isinstance(s, tuple))
        pad = [tuple(w) + (None,) * (len(g) - len(w)) for w, g in zip(flat_w, flat_g)]
        assert pad == flat_g, cfg


def test_fused_sites_split_per_member(qtpu_refs):
    """A rank's qkv_proj / gateup_proj shard is [q_r | k_r | v_r] /
    [gate_r | up_r] of the unfused sites' shards, byte for byte."""
    from qtpu_torch.quant.apply import fuse_packed_sites, pack_model
    from qtpu_torch.sharding.specs import shard_params

    payload, _ = qtpu_refs
    cfg = payload["cfgs"]["llama"]
    packed, qmeta = pack_model(payload["llama"], "rtn", {"w_bit": 4, "q_group_size": 64})
    fused, _ = fuse_packed_sites(packed, qmeta)
    for r in range(2):
        loose = shard_params(packed, 2, rank=r, cfg=cfg)["layers"]
        tight = shard_params(fused, 2, rank=r, cfg=cfg)["layers"]
        for fname, parts in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                             ("gateup_proj", ("gate_proj", "up_proj"))):
            for key in ("data", "scales", "zeros"):
                want = torch.cat([loose[s][key] for s in parts], dim=-1)
                assert torch.equal(tight[fname][key], want), (fname, key, r)


def test_row_parallel_packed_shard_equals_packing_the_k_slice(qtpu_refs):
    """W4's group-halves layout keeps a group's bytes in contiguous rows, so
    a row-parallel shard of the packed site equals packing the dense K
    slice."""
    from qtpu_torch.core.packing import quantize_pack
    from qtpu_torch.quant.apply import pack_model
    from qtpu_torch.sharding.specs import shard_params

    payload, _ = qtpu_refs
    p = payload["llama"]
    packed, _ = pack_model(p, "rtn", {"w_bit": 4, "q_group_size": 64})
    for r in range(2):
        got = shard_params(packed, 2, rank=r, cfg=payload["cfgs"]["llama"])["layers"]
        for site in ("o_proj", "down_proj"):
            w = p["layers"][site]["w"][0]
            K = w.shape[0]
            want = quantize_pack(w[r * K // 2:(r + 1) * K // 2], 4, 64)
            for key in ("data", "scales", "zeros"):
                assert torch.equal(got[site][key][0], getattr(want, key)), (site, key, r)


def test_undividable_dims_raise(qtpu_refs):
    """Where qtpu's device_put raises (a dim its table shards that tp does
    not divide) the port raises ValueError naming the dim: the vocabulary,
    the experts, q_dim. KV 3 at tp 2 and a row-parallel site whose groups
    tp does not divide run instead (the uneven cases below)."""
    from qtpu_torch.sharding.specs import local_config, shard_params

    payload, _ = qtpu_refs
    cfg = payload["cfgs"]["llama"]
    with pytest.raises(ValueError, match="vocab_size"):
        local_config(cfg.replace(vocab_size=50257), 2)  # GPT-2's vocabulary
    with pytest.raises(ValueError, match="num_experts"):  # 4 experts over tp 8
        shard_params(payload["moe"], 8, "moe", rank=0, cfg=payload["cfgs"]["moe"])
    with pytest.raises(ValueError, match="q_dim"):  # 5 heads of 20
        local_config(cfg.replace(num_heads=5, num_kv_heads=1, head_dim=20), 8)


def test_boundary_branch_under_tp_raises(world):
    assert "QTPU_BOUNDARY" in case(world, "boundary")


@pytest.mark.parametrize("arch,tol", [("llama", 2e-2), ("gpt2", 3e-2), ("opt", 3e-2)])
def test_tp_dp_forward_matches_qtpu_and_unsharded(world, qtpu_refs, arch, tol):
    payload, want = qtpu_refs
    got = rows(world, f"fwd_{arch}")
    _close(got, want[f"fwd_{arch}"], tol)
    _close(got, _port(payload, arch), tol)
    # the model ranks agree
    np.testing.assert_array_equal(case(world, f"fwd_{arch}", 1), case(world, f"fwd_{arch}", 0))


@pytest.mark.parametrize("name,qkey", [("packed", "packed_qmeta"), ("actorder", "actorder_qmeta")])
def test_tp_dp_packed_forward_matches_qtpu(world, qtpu_refs, name, qkey):
    payload, want = qtpu_refs
    got = rows(world, f"fwd_{name}")
    _close(got, want[f"fwd_{name}"], 2e-2)
    _close(got, _port(payload, "llama", f"llama_{name}", payload[qkey]), 2e-2)


@pytest.mark.parametrize("arch,tol", [("llama", 2e-2), ("opt", 3e-2)])
def test_tp_dp_decode_matches_qtpu(world, qtpu_refs, arch, tol):
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    payload, want = qtpu_refs
    name = "decode" if arch == "llama" else "decode_opt"
    got = np.concatenate([case(world, name, r)["logits"].numpy() for r in (0, 2)])
    cfg = payload["cfgs"][arch]
    assert case(world, name)["kv_shape"][2] == cfg.num_kv_heads // 2  # the rank's KV heads
    _close(got, want[name], tol)
    # the port unsharded, teacher-forced on the sharded run's tokens
    params = payload["llama_fused" if arch == "llama" else "opt_fused"]
    qmeta = payload["fused_qmeta" if arch == "llama" else "opt_qmeta"]
    prompt = payload["ids"][:4, :16]
    cache = init_cache(cfg, 4, 32, quantized=True, device="cpu")
    logits, cache = prefill(params, prompt, cache, cfg, qmeta, arch=arch)
    ref = [logits.numpy()]
    pos = torch.full((4,), 16, dtype=torch.int32)
    for i in range(3):
        tok = torch.from_numpy(got[:, i].argmax(-1)).to(torch.int32)
        logits, cache = decode_step(params, tok, pos, cache, cfg, qmeta, arch=arch)
        ref.append(logits.numpy())
        pos = pos + 1
    ref = np.stack(ref, 1)
    _close(got, ref, tol)
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    assert (got.argmax(-1) == ref.argmax(-1))[clear].all()


def test_dp_perplexity_equals_serial(world, qtpu_refs):
    from qtpu_torch.eval.perplexity import evaluate_perplexity

    payload, _ = qtpu_refs
    serial = evaluate_perplexity(payload["llama_packed"], payload["stream"],
                                 payload["cfgs"]["llama"], n_samples=6, block_size=64,
                                 qmeta=payload["packed_qmeta"])
    got = [case(world, "ppl_dp", r) for r in range(WORLD)]
    assert len(set(got)) == 1
    assert abs(got[0] / serial - 1) < 1e-5, (got[0], serial)
    tp = case(world, "ppl_tp")
    assert abs(tp / serial - 1) < 1e-2, (tp, serial)


def test_runner_mesh_config_runs_sharded(world):
    from qtpu_torch.bench import QuantizationBenchmark

    results, meshed = case(world, "runner")
    assert meshed
    bench = QuantizationBenchmark(dict(RUN_CONFIG), device="cpu")
    bench.run_all_benchmarks()
    assert set(results) == set(bench.results) == {"raw", "rtn", "awq", "serving"}
    for name in ("raw", "rtn", "awq"):
        want = bench.results[name].to_dict()
        assert results[name]["error"] is None, results[name]
        assert abs(results[name]["perplexity"] / want["perplexity"] - 1) < 1e-2, name
        if name != "raw":
            assert abs(results[name]["packed_perplexity"] / want["packed_perplexity"] - 1) < 1e-2
    assert results["serving"]["tokens_per_second"] > 0


def test_runner_mesh_above_the_world_runs_single_device(capsys):
    from qtpu_torch.bench import QuantizationBenchmark

    cfg = dict(RUN_CONFIG, quantization_methods=[], serving={"benchmark": False},
               verbose=True, mesh={"data": 2, "model": 2})
    bench = QuantizationBenchmark(cfg, device="cpu")
    bench.run_all_benchmarks()
    assert bench.mesh is None and bench.results["raw"].is_success()
    assert "needs 4 devices, have 1 — running single-device" in capsys.readouterr().out


def test_moe_expert_parallel_forward_matches_qtpu(world, qtpu_refs):
    payload, want = qtpu_refs
    got = rows(world, "fwd_moe")
    _close(got, want["fwd_moe"], 3e-2)
    _close(got, _port(payload, "moe"), 3e-2)


@pytest.mark.parametrize("shape", [(4, 8), (4, 1), (1, 1)])
def test_moe_expert_parallel_routes(world, shape):
    got, want, gathered = case(world, "moe_routes")[shape]
    assert gathered == (shape == (1, 1))  # K10's route at one slot, K9's otherwise
    _close(got, want, 3e-2)


# ------------------------------------------- tp 4 over 2 KV heads
def test_tp_over_the_kv_heads_holds_each_ranks_kv_head(qtpu_refs):
    """At tp 4 over 2 KV heads rank r holds KV head r // 2, whole, in k_proj
    / v_proj and in the k and v members of the fused qkv_proj (data,
    scales and zeros alike); its config and qmeta say one KV head."""
    from qtpu_torch.sharding.specs import local_config, shard_params, shard_qmeta

    payload, _ = qtpu_refs
    cfg = payload["cfgs"]["tl"]
    hd, Q, KVd = cfg.head_dim, cfg.q_dim, cfg.kv_dim
    lc = local_config(cfg, 4)
    assert (lc.num_heads, lc.num_kv_heads) == (4, 1)
    fused, fq = payload["tl_fused"], payload["tl_qmeta"]
    lq = dict(shard_qmeta(fq, 4, "llama", cfg))
    assert lq["qkv_proj"][3] == Q // 4 + 2 * hd
    for r in range(4):
        h = r // 2
        raw = shard_params(payload["tl"], 4, rank=r, cfg=cfg)["layers"]
        for site in ("k_proj", "v_proj"):
            whole = payload["tl"]["layers"][site]["w"]
            assert torch.equal(raw[site]["w"], whole[..., h * hd:(h + 1) * hd])
        got = shard_params(fused, 4, rank=r, cfg=cfg)["layers"]["qkv_proj"]
        for key in ("data", "scales", "zeros"):
            whole = fused["layers"]["qkv_proj"][key]
            want = torch.cat([whole[..., r * Q // 4:(r + 1) * Q // 4],
                              whole[..., Q + h * hd:Q + (h + 1) * hd],
                              whole[..., Q + KVd + h * hd:Q + KVd + (h + 1) * hd]], -1)
            assert torch.equal(got[key], want), (key, r)


@pytest.mark.parametrize("key", list(TP4))
def test_tp_over_the_kv_heads_forward_matches_qtpu_and_unsharded(world, qtpu_refs, key):
    """The forward at tp 4 over 2 KV heads (raw and packed W4; MoE with one
    expert a rank) against qtpu's tp 4 forward and the port's one-rank one:
    2e-2 (llama), 3e-2 (MoE); every rank gives the same logits."""
    payload, want = qtpu_refs
    name, qname, ckey = TP4[key]
    tol = 3e-2 if ckey == "moe" else 2e-2
    got = case(world, f"tp4_fwd_{key}")
    cfg = payload["cfgs"][ckey]
    qmeta = payload[qname] if qname else None
    one = get_arch(cfg.arch).forward(payload[name], payload["ids"][:TP4_ROWS], cfg,
                                     qmeta=qmeta).numpy()
    _close(got, want[f"tp4_fwd_{key}"], tol)
    _close(got, one, tol)
    for r in range(1, WORLD):
        np.testing.assert_array_equal(case(world, f"tp4_fwd_{key}", r), got)


@pytest.mark.parametrize("key", TP4_DECODE)
def test_tp_over_the_kv_heads_decode_matches_one_rank(world, qtpu_refs, key):
    """Prefill and 3 greedy decode steps at tp 4 over 2 KV heads on the int8
    cache (one KV head a rank) against the port's one-rank run
    teacher-forced on the sharded tokens: logits within 2e-2 (llama), 3e-2
    (MoE); greedy tokens equal where the top-2 gap exceeds 5e-2."""
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache

    payload, _ = qtpu_refs
    name, qname, ckey = TP4[key]
    cfg = payload["cfgs"][ckey]
    tol = 3e-2 if ckey == "moe" else 2e-2
    res = case(world, f"tp4_decode_{key}")
    assert res["kv_shape"][2] == 1  # one KV head a rank
    got = res["logits"].numpy()
    params, qmeta = payload[name], payload[qname]
    prompt = payload["ids"][:TP4_ROWS, :16]
    cache = init_cache(cfg, TP4_ROWS, 32, quantized=True, device="cpu")
    logits, cache = prefill(params, prompt, cache, cfg, qmeta, arch=cfg.arch)
    ref = [logits.numpy()]
    pos = torch.full((TP4_ROWS,), 16, dtype=torch.int32)
    for i in range(3):
        tok = torch.from_numpy(got[:, i].argmax(-1)).to(torch.int32)
        logits, cache = decode_step(params, tok, pos, cache, cfg, qmeta, arch=cfg.arch)
        ref.append(logits.numpy())
        pos = pos + 1
    ref = np.stack(ref, 1)
    _close(got, ref, tol)
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    assert (got.argmax(-1) == ref.argmax(-1))[clear].all()
    for r in range(1, WORLD):
        np.testing.assert_array_equal(case(world, f"tp4_decode_{key}", r)["logits"].numpy(), got)


# ------------------------------------------- uneven splits
@pytest.mark.parametrize("H,KV,tp", [(28, 4, 8), (14, 2, 2), (14, 2, 4), (14, 2, 8), (6, 3, 2),
                                     (6, 3, 4), (6, 2, 4), (12, 12, 8), (32, 4, 8), (4, 2, 8),
                                     (2, 1, 4)])
def test_head_split_rule(H, KV, tp):
    """Each rank's q heads are one contiguous block, whole KV groups or part
    of one group; it holds exactly the KV heads they read, through one
    uniform mapping; the blocks are as even as the rule allows and, where
    tp divides the heads, equal to the even split."""
    from qtpu_torch.sharding.specs import head_split

    cuts = head_split(tconfig.TINY_TEST.replace(num_heads=H, num_kv_heads=KV), tp)
    G = H // KV
    assert len(cuts) == tp and cuts[0][0][0] == 0 and cuts[-1][0][1] == H
    assert all(a[0][1] == b[0][0] for a, b in zip(cuts, cuts[1:]))
    sizes = [h1 - h0 for (h0, h1), _ in cuts]
    for (h0, h1), (v0, v1) in cuts:
        if h1 == h0:
            assert v1 == v0
            continue
        assert (h0 % G == 0 and h1 % G == 0) or h0 // G == (h1 - 1) // G
        assert (v0, v1) == (h0 // G, (h1 - 1) // G + 1)
        assert (h1 - h0) % (v1 - v0) == 0
    best = -(-G // (tp // KV)) if tp > KV else G * -(-KV // tp)
    assert max(sizes) == best
    if H % tp == 0 and (KV % tp == 0 or tp % KV == 0):
        assert sizes == [H // tp] * tp


def test_uneven_layouts_of_the_named_cases():
    """Qwen2-7B at tp 8: each group of 7 q heads 4 + 3, one KV head a rank;
    H 6 / KV 3 at tp 2: KV 2 + 1, q 4 + 2; TinyLlama W4 g128 at tp 8:
    down_proj's 44 groups 6 or 5 a rank, gate / up cut to match; H 6 / KV
    2 / I 384 at g128, tp 2: o_proj's 3 groups 2 + 1 over a gathered
    attention output, down_proj's 2 + 1; each rank's qmeta says so."""
    from qtpu_torch.sharding.specs import local_config, plan, shard_qmeta

    cuts = plan(tconfig.QWEN2_7B, 8)
    assert [c.heads[1] - c.heads[0] for c in cuts] == [4, 3] * 4
    assert [c.kv for c in cuts] == [(g, g + 1) for g in range(4) for _ in range(2)]
    cuts = plan(tconfig.TINY_TEST.replace(num_heads=6, num_kv_heads=3), 2)
    assert [(c.heads, c.kv) for c in cuts] == [((0, 4), (0, 2)), ((4, 6), (2, 3))]
    tl = tconfig.TINYLLAMA_1_1B
    qmeta = (("down_proj", (4, 128, 5632, 2048)), ("gateup_proj", (4, 128, 2048, 11264)),
             ("o_proj", (4, 128, 2048, 2048)), ("qkv_proj", (4, 128, 2048, 2560)))
    for r in range(8):
        lc, lq = local_config(tl, 8, r, qmeta), dict(shard_qmeta(qmeta, 8, "llama", tl, r))
        groups = 6 if r < 4 else 5
        assert lc.intermediate_size == groups * 128 == lq["down_proj"][2]
        assert lq["gateup_proj"][3] == 2 * groups * 128 and lq["qkv_proj"][3] == 256 + 128
        assert lc.o_gather == ()
    cfg = tconfig.TINY_TEST.replace(num_heads=6, num_kv_heads=2, intermediate_size=384)
    qmeta = (("down_proj", (4, 128, 384, 256)), ("o_proj", (4, 128, 384, 256)))
    lcs = [local_config(cfg, 2, r, qmeta) for r in range(2)]
    assert [(c.num_heads, c.num_kv_heads, c.intermediate_size) for c in lcs] == [
        (3, 1, 256), (3, 1, 128)]
    assert [c.o_gather for c in lcs] == [((192, 192), 0, 256), ((192, 192), 256, 384)]
    assert [dict(shard_qmeta(qmeta, 2, "llama", cfg, r))["o_proj"][2] for r in range(2)] == [
        256, 128]
    with pytest.raises(ValueError, match="name the rank"):
        local_config(tconfig.QWEN2_7B, 8)


def _w8a8_close(got, want):
    """The relative Frobenius error of W8A8 logits within 3e-2, the measure
    of the port's W8A8 model against qtpu's (test_torch_quant.LOGIT_TOL): a
    bf16 difference of the activations, a sum's order, moves a per-token
    int8 code here and there, and the port's and qtpu's one-rank runs
    differ by 0.039 in a logit on these inputs. (The port's TP runs equal
    its one-rank run: the ranks' f32 partials are summed before the one
    rounding.)"""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 3e-2


def test_a_perm_across_the_ranks_rows_gathers_its_sites_input(qtpu_refs):
    """GPTQ actorder with one perm over all of K: both row-parallel sites
    of every rank take the whole gathered input, their perms stay global
    (rows [k0, k1) of the permuted weight); a shard-local perm gathers
    nothing."""
    from qtpu_torch.sharding.specs import local_config, shard_params

    payload, _ = qtpu_refs
    cfg, params, qmeta = payload["cfgs"]["llama"], payload["llama_perm"], payload["perm_qmeta"]
    for r in range(2):
        lc = local_config(cfg, 2, r, qmeta, params)
        assert lc.o_gather == ((128, 128), 0, 256) and lc.mlp_gather == ((256, 256), 0, 512)
        local = shard_params(params, 2, rank=r, cfg=cfg, qmeta=qmeta)["layers"]
        for site, K in (("o_proj", 256), ("down_proj", 512)):
            whole = params["layers"][site]["perm"]
            assert torch.equal(local[site]["perm"], whole[..., r * K // 2:(r + 1) * K // 2])
        shards = local_config(cfg, 2, r, payload["actorder_qmeta"], payload["llama_actorder"])
        assert shards.o_gather == () and shards.mlp_gather == ()


@pytest.mark.parametrize("key", list(UNEVEN))
def test_uneven_tp_forward_matches_qtpu_and_one_rank(world, qtpu_refs, key):
    """The forward of each uneven case against qtpu's bench path (its
    sharded dense tree packed under the mesh) and the port's one-rank
    forward: 2e-2 (llama), 3e-2 (OPT); the ranks of a data shard agree.
    W8A8 against qtpu is held by the measure of the port's W8A8 model
    against qtpu's (`_w8a8_close`)."""
    payload, want = qtpu_refs
    name, qname, ckey, tp = UNEVEN[key]
    cfg = payload["cfgs"][ckey]
    tol = 3e-2 if cfg.arch == "opt" else 2e-2
    res = f"uneven_fwd_{key}"
    got = rows(world, res, range(0, WORLD, tp))
    one = get_arch(cfg.arch).forward(payload[name], payload["ids"][:TP4_ROWS], cfg,
                                     qmeta=payload[qname] if qname else None).numpy()
    if qname == "w8a8_qmeta":
        _w8a8_close(got, want[res])
    else:
        _close(got, want[res], tol)
    _close(got, one, tol)
    for r in range(WORLD):
        np.testing.assert_array_equal(case(world, res, r), case(world, res, r - r % tp))


@pytest.mark.parametrize("key", list(UNEVEN_DECODE))
def test_uneven_tp_decode_matches_one_rank(world, qtpu_refs, key):
    """Prefill and 3 greedy decode steps of the uneven cases on the int8
    cache (each rank's cache holds its KV heads) against the port's
    one-rank run teacher-forced on the sharded tokens: logits within 2e-2,
    greedy tokens equal where the top-2 gap exceeds 5e-2."""
    from qtpu_torch.serve.decode import decode_step, prefill
    from qtpu_torch.serve.kvcache import init_cache
    from qtpu_torch.sharding.specs import head_split

    payload, _ = qtpu_refs
    name, qname, ckey, tp = UNEVEN_DECODE[key]
    cfg = payload["cfgs"][ckey]
    res = f"uneven_decode_{key}"
    for r in range(WORLD):
        v0, v1 = head_split(cfg, tp)[r % tp][1]
        assert case(world, res, r)["kv_shape"][2] == v1 - v0
    got = np.concatenate([case(world, res, r)["logits"].numpy() for r in range(0, WORLD, tp)])
    params, qmeta = payload[name], payload[qname]
    prompt = payload["ids"][:TP4_ROWS, :16]
    cache = init_cache(cfg, TP4_ROWS, 32, quantized=True, device="cpu")
    logits, cache = prefill(params, prompt, cache, cfg, qmeta)
    ref = [logits.numpy()]
    pos = torch.full((TP4_ROWS,), 16, dtype=torch.int32)
    for i in range(3):
        tok = torch.from_numpy(got[:, i].argmax(-1)).to(torch.int32)
        logits, cache = decode_step(params, tok, pos, cache, cfg, qmeta)
        ref.append(logits.numpy())
        pos = pos + 1
    ref = np.stack(ref, 1)
    _close(got, ref, 2e-2)
    top2 = np.sort(ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > GAP
    assert (got.argmax(-1) == ref.argmax(-1))[clear].all()


# every preset once (the aliases share a config)
PRESETS = sorted({cfg: name for name, cfg in reversed(list(tconfig.PRESET_MODELS.items()))}
                 .values())


@functools.lru_cache(maxsize=None)
def _qtpu_divides(name: str, tp: int) -> bool:
    """Whether qtpu's shard_params accepts the preset's dense tree at tp:
    every dim its param_specs shards divides by tp (jax.eval_shape of
    qtpu's init_params, no weights made)."""
    import jax

    from qtpu.models import config as jconfig
    from qtpu.models import get_arch as jget
    from qtpu.sharding.specs import param_specs

    jcfg = jconfig.ModelConfig(**dataclasses.asdict(tconfig.PRESET_MODELS[name]))
    shapes = jax.eval_shape(lambda: jget(jcfg.arch).init_params(jcfg, jax.random.PRNGKey(0)))
    specs = param_specs(shapes, jcfg.arch)
    leaves = jax.tree_util.tree_leaves(shapes)
    flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    return all(leaf.shape[i] % tp == 0 for leaf, spec in zip(leaves, flat)
               for i, ax in enumerate(spec) if ax == "model")


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("name", PRESETS)
def test_tp_accepts_exactly_where_qtpus_dense_tree_divides(name, tp):
    from qtpu_torch.sharding.specs import local_config

    cfg = tconfig.PRESET_MODELS[name]
    if _qtpu_divides(name, tp):
        for r in range(tp):
            lc = local_config(cfg, tp, r)
            assert lc.num_heads * lc.head_dim <= cfg.q_dim
    else:
        with pytest.raises(ValueError, match="does not divide"):
            local_config(cfg, tp, 0)
