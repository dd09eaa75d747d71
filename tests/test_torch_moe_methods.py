"""The MoE methods of the port against qtpu on the CPU: routed calibration,
qtpu's statistics view of the flattened expert axis, every method's
quantize_model / pack_model on the expert sites, the packed forward and
greedy decoding on the grouped and gathered routes, the benchmark's sizes
and the serve CLI, on tiny-moe-test (Mixtral's layout) and
tiny-qwen2-moe-test (a shared expert), from the same numpy-made weights and
calibration ids.

Tolerances, each with its reason:
  * statistics: 2e-2 relative Frobenius error per site (the activations are
    bf16 in both packages, rounded at other points: the attention's and the
    experts' sums run in other orders); the routed mask is the same;
  * AWQ bit for bit, SmoothQuant's smooth vectors within 2 ulps (torch.pow
    takes x^0.5 as sqrt) and its other leaves >= 99% of bytes equal, as on
    the dense model (tests/test_torch_quant.py) -- both from qtpu's stats;
  * GPTQ: at most 2% of weights a code step off qtpu's and 3e-2 relative
    error (torch.linalg's Cholesky sums in another order, tests/test_torch_gptq.py);
    the port's packed codes dequantized against its own fake-quant weights
    within one bf16 ulp (one rounding of the same f32 value);
  * POT/APOT: groups that differ are ties of the scale race or in XLA's
    floor(log2) window (tests/test_torch_pot.py's rule);
  * logits: 2e-2 relative (bf16 layers, other sum orders), 3e-2 where the
    two packages' own codes differ by the flips above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtpu.calib.stats import CalibStats as JStats
from qtpu.calib.stats import collect_calibration_stats as jax_collect
from qtpu.core.sizing import get_model_size as jax_model_size
from qtpu.models import moe as jmoe
from qtpu.quant import apply as japply
from qtpu.serve import kvcache as jkv
from qtpu_torch.bench import QuantizationBenchmark
from qtpu_torch.calib import collect_calibration_stats
from qtpu_torch.convert import params_to_numpy, params_to_torch, stats_to_torch
from qtpu_torch.core.packing import dequantize_parts
from qtpu_torch.kernels import codebook_matmul as k7
from qtpu_torch.kernels import moe_matmul as k9
from qtpu_torch.models import llama as tllama
from qtpu_torch.models import moe as tmoe
from qtpu_torch.quant import apply as tapply
from qtpu_torch.serve import kvcache as tkv
from qtpu_torch.serve.__main__ import main as serve_main
from test_torch_gptq import _qtpu_jit
from test_torch_moe import CONFIGS, _np_moe_params, _rel, cpu
from test_torch_pot import _check_groups, _cols, _window_groups
from test_torch_quant import BF16, _bits_equal, _ulps, one_torch_thread  # noqa: F401  (a fixture)

STAT_TOL = 2e-2
LOGIT_TOL = 2e-2
FLIP_LOGIT_TOL = 3e-2
MODEL_FLIPS = 0.02
MODEL_W_TOL = 3e-2
TIE_MARGIN = 5e-2  # router logit gap under which a token may route apart (a few bf16 ulps)
G = 64
MCFG = {
    "rtn": {"w_bit": 4, "q_group_size": G},
    "awq": {"w_bit": 4, "q_group_size": G, "protect_ratio": 0.05, "scale_factor": 2.0},
    "smoothquant": {"w_bit": 4, "q_group_size": G, "alpha": 0.5},
    "smoothquant_a8": {"w_bit": 8, "q_group_size": G, "alpha": 0.5, "act_quant": True},
    "gptq": {"w_bit": 4, "q_group_size": G, "error_compensation": True},
    "gptq_actorder": {"w_bit": 4, "q_group_size": G, "error_compensation": True,
                      "actorder": True},
    # a coarser scale grid than the reference's (both packages take it), so
    # the candidate search stays short on the CPU
    "pot": {"w_bit": 4, "q_group_size": G, "grid_step": 0.1},
    "apot": {"w_bit": 4, "q_group_size": G, "grid_step": 0.1},
}
_QTPU = {}  # qtpu's results, once per module (its programs compile slowly)


def _method(case):
    return case.split("_")[0]


def _true_h(case):
    return case == "gptq"  # gptq_actorder takes the proxy Hessians (no true ones)


def _batches(n=4, S=160, seed=5):
    """640 calibration tokens: every expert sees more routed rows than its
    128-wide down-projection input, so its true Hessian has full rank."""
    return [np.random.default_rng(seed + i).integers(0, 512, (1, S), dtype=np.int32)
            for i in range(n)]


def _np_stats(js):
    return {f: {k: np.asarray(v) for k, v in getattr(js, f).items()}
            for f in ("mean_abs", "max_abs", "hessian")}


@pytest.fixture(scope="module", params=list(CONFIGS))
def moe(request):
    """(name, qtpu cfg, port cfg, numpy params, qtpu params, port params,
    qtpu's stats with true Hessians as numpy fields)."""
    jcfg, tcfg = CONFIGS[request.param]
    p = _np_moe_params(tcfg, seed=3)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    js = _np_stats(jax_collect(jmoe.forward, pj, _batches(), jcfg, collect_hessian=True))
    return request.param, jcfg, tcfg, p, pj, params_to_torch(p, device="cpu"), js


def _jstats(js, hessian):
    conv = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return JStats(mean_abs=conv(js["mean_abs"]), max_abs=conv(js["max_abs"]),
                  hessian=conv(js["hessian"]) if hessian else None, n_batches=4)


def _tstats(js, hessian):
    return stats_to_torch(_jstats(js, hessian), device="cpu")


def _once(key, fn):
    if key not in _QTPU:
        _QTPU[key] = fn()
    return _QTPU[key]


def _qtpu_pack(moe, case):
    name, _, _, _, pj, _, js = moe
    mcfg, h = MCFG[case], _true_h(case)
    if _method(case) == "gptq":  # under one jax.jit, as tests/test_torch_gptq.py runs it
        run = lambda: _qtpu_jit(lambda a, st: japply.pack_model(a, "gptq", mcfg, st, "moe"),  # noqa: E731
                                pj, _JS(js), h)
    else:
        run = lambda: japply.pack_model(pj, _method(case), mcfg, _jstats(js, False), "moe")  # noqa: E731
    return _once((name, "pack", case), run)


class _JS:
    """The numpy fields as tests/test_torch_gptq.py's _qtpu_jit takes them."""

    def __init__(self, js):
        self.mean_abs, self.max_abs, self.hessian = js["mean_abs"], js["max_abs"], js["hessian"]
        self.n_batches = 4


def _port_pack(moe, case):
    *_, pt, js = moe
    return tapply.pack_model(pt, _method(case), MCFG[case], _tstats(js, _true_h(case)), "moe")


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("capture", ["stats", "hessian"])
def test_routed_stats_equal_qtpu_on_the_same_inputs(capture):
    """_routed_stats on one activation and routing (some experts with no
    routed token): qtpu's [B, S, E, F] layout against the port's [E, M, F],
    within f32 summation order (1e-5 relative)."""
    rng = np.random.default_rng(17)
    B, S, E, F, k = 2, 12, 4, 32, 2
    act = rng.standard_normal((B, S, E, F)).astype(np.float32).astype(BF16)
    w = np.zeros((B, S, E), np.float32)
    for b in range(B):
        for t in range(S):
            w[b, t, rng.choice(3, k, replace=False)] = rng.uniform(0.1, 1.0, k)  # expert 3 idle
    want = jmoe._routed_stats(jnp.asarray(act), jnp.asarray(w), capture)
    got = tmoe._routed_stats(cpu(act).reshape(B * S, E, F).transpose(0, 1), cpu(w).reshape(B * S, E),
                             capture)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5, atol=1e-6)
    assert float(got["mean_abs"][3].abs().max()) == 0.0


@pytest.mark.parametrize("capture", ["stats", "hessian"])
def test_moe_mlp_capture_equals_qtpu_on_the_same_hidden_states(moe, capture):
    """One layer's expert MLP on the same hidden states: the same routing,
    exp_down_in over each expert's routed tokens ([E, F], hessian [E, F,
    F]) and sh_down_in on Qwen2-MoE, within STAT_TOL of qtpu's."""
    name, jcfg, tcfg, _, pj, pt, _ = moe
    rng = np.random.default_rng(11)
    h = rng.standard_normal((2, 24, tcfg.hidden_size)).astype(np.float32).astype(BF16)
    lpj = jax.tree_util.tree_map(lambda a: a[1], pj["layers"])
    np.testing.assert_array_equal(
        tmoe._routing_weights(cpu(h).reshape(48, -1), pt["layers"], tcfg, lambda s: None, 1)
        .numpy() > 0,
        np.asarray(jmoe._routing_weights(jnp.asarray(h), lpj, jcfg, lambda s: None)).reshape(48, -1)
        > 0)
    out_j, st_j, sh_j = jmoe._moe_mlp(jnp.asarray(h), lpj, jcfg, lambda s: None, capture)
    cap = tllama._Capture(capture, tcfg.num_layers)
    out_t = tmoe._moe_mlp(cpu(h), pt["layers"], tcfg, lambda s: None, 1, cap)
    assert _rel(out_t.float().numpy(), np.asarray(out_j, np.float32)) < LOGIT_TOL
    want = {"exp_down_in": st_j, **({"sh_down_in": sh_j} if sh_j is not None else {})}
    assert set(cap.stats) == set(want) == ({"exp_down_in", "sh_down_in"} if name == "qwen2_moe"
                                           else {"exp_down_in"})
    for site, st in want.items():
        for key, a in st.items():
            got = cap.stats[site][key][1]
            assert tuple(got.shape) == a.shape, (site, key)
            assert _rel(got.numpy(), a) < STAT_TOL, (site, key)


def _expert_pairs_close(got, want, L, E):
    """exp_down_in of a whole-model run, where the layers' inputs differ by
    bf16 roundings: a router near-tie then sends a token to another expert
    in one package (ROADMAP section 3, MoE routing), which moves it between
    two (layer, expert) pairs. At least 3 of 4 pairs within STAT_TOL, all
    within 0.25."""
    g = got.reshape(-1, L, E, *got.shape[-1:]) if got.ndim == want.ndim else got
    errs = [_rel(g[..., l, e, :], want[..., l, e, :]) for l in range(L) for e in range(E)]
    assert np.mean(np.asarray(errs) < STAT_TOL) >= 0.75, errs
    assert max(errs) < 0.25, errs


@pytest.mark.parametrize("capture", ["stats", "hessian"])
def test_capture_forward_routes_expert_stats_as_qtpu(moe, capture):
    """One capture forward: the logits, and per input site the statistics'
    keys, shapes and values (exp_down_in per expert, [L, E, F], over its
    routed tokens; sh_down_in on Qwen2-MoE), the shared-input sites within
    STAT_TOL, exp_down_in pair by pair (_expert_pairs_close)."""
    name, jcfg, tcfg, _, pj, pt, _ = moe
    ids = _batches(1, S=48, seed=9)[0]
    lj, sj = jmoe.forward(pj, jnp.asarray(ids), jcfg, capture=capture)
    lt, st = tmoe.forward(pt, cpu(ids), tcfg, capture=capture)
    assert _rel(lt.numpy(), lj) < LOGIT_TOL
    want_sites = {"attn_in", "o_in", "mlp_in", "exp_down_in", "head_in"}
    if name == "qwen2_moe":
        want_sites.add("sh_down_in")
    assert set(st) == set(sj) == want_sites
    L, E, F = tcfg.num_layers, tcfg.num_experts, tcfg.intermediate_size
    assert tuple(st["exp_down_in"]["mean_abs"].shape) == (L, E, F)
    for site in st:
        assert set(st[site]) == set(sj[site])
        for key, want in sj[site].items():
            got = st[site][key]
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, (site, key)
            if site == "exp_down_in" and key != "hessian":
                _expert_pairs_close(got.numpy(), np.asarray(want), L, E)
            elif site != "exp_down_in":
                assert _rel(got.numpy(), want) < STAT_TOL, (site, key)
    if capture == "hessian":
        assert tuple(st["exp_down_in"]["hessian"].shape) == (L, E, F, F)


def test_collect_calibration_stats_carry_the_expert_axis(moe):
    """collect_calibration_stats over 4 batches: mean_abs [S, L, E, F] for
    exp_down_in, max_abs [L, E, F], hessian [L, E, F, F]; the shared-input
    sites as on llama, within STAT_TOL of qtpu's; exp_down_in pair by pair
    (_expert_pairs_close)."""
    name, jcfg, tcfg, _, _, pt, js = moe
    got = collect_calibration_stats(tmoe.forward, pt, _batches(), tcfg, collect_hessian=True)
    L, E, F, D = tcfg.num_layers, tcfg.num_experts, tcfg.intermediate_size, tcfg.hidden_size
    assert tuple(got.mean_abs["exp_down_in"].shape) == (4, L, E, F)
    assert tuple(got.max_abs["exp_down_in"].shape) == (L, E, F)
    assert tuple(got.hessian["exp_down_in"].shape) == (L, E, F, F)
    assert tuple(got.mean_abs["mlp_in"].shape) == (4, L, D)
    assert tuple(got.hessian["head_in"].shape) == (D, D)
    for field in ("mean_abs", "max_abs", "hessian"):
        mine, want = getattr(got, field), js[field]
        assert set(mine) == set(want)
        for site in want:
            assert tuple(mine[site].shape) == want[site].shape
            if site == "exp_down_in" and field != "hessian":
                _expert_pairs_close(mine[site].numpy(), want[site], L, E)
            elif site != "exp_down_in":
                assert _rel(mine[site].numpy(), want[site]) < STAT_TOL, (field, site)


def test_expert_stats_view_equals_qtpu(moe):
    """From the same stats: per-expert sites merge L and E, shared ones
    repeat each layer's vector E times, head_in passes, bit for bit; `keep`
    leaves out the sites it does not name."""
    _, _, tcfg, _, _, _, js = moe
    E = tcfg.num_experts
    want = japply._expert_stats_view(_jstats(js, True), E, ("exp_down_in",))
    got = tapply._expert_stats_view(_tstats(js, True), E, ("exp_down_in",))
    for field in ("mean_abs", "max_abs", "hessian"):
        w, g = getattr(want, field), getattr(got, field)
        assert set(g) == set(w)
        for site in w:
            _bits_equal(g[site].numpy(), np.asarray(w[site]))
    assert got.n_batches == want.n_batches
    kept = tapply._expert_stats_view(_tstats(js, True), E, ("exp_down_in",),
                                     keep={"mlp_in", "exp_down_in"})
    assert set(kept.mean_abs) == set(kept.hessian) == {"mlp_in", "exp_down_in"}
    assert tapply._expert_stats_view(None, E, ("exp_down_in",)) is None


# ------------------------------------------------------------ the methods
@pytest.mark.parametrize("case", ["awq", "smoothquant"])
def test_quantize_model_on_expert_sites_matches_qtpu(moe, case):
    """Fake-quant from qtpu's stats: AWQ bit for bit; SmoothQuant's smooth
    vectors ([L, E, K] on expert sites) within 2 ulps and its weights >= 99%
    equal (the rest one quantization step off, tests/test_torch_quant.py)."""
    name, _, tcfg, _, pj, pt, js = moe
    mcfg = MCFG[case]
    want = _once((name, "fake", case), lambda: japply.quantize_model(
        pj, case, mcfg, _jstats(js, False), "moe"))
    got = params_to_numpy(tapply.quantize_model(pt, case, mcfg, _tstats(js, False), "moe"))
    lw = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    lg = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(lg) == set(lw)
    for path, w in lw.items():
        g, w = np.asarray(lg[path]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if "smooth" in str(path):
            assert _ulps(g, w) <= 2, path
        elif case == "smoothquant" and str(path[-1]) == "['w']":
            assert (g.astype(np.float32) == w.astype(np.float32)).mean() >= 0.99, path
        else:
            _bits_equal(g, w)
    L, E = tcfg.num_layers, tcfg.num_experts
    if case == "smoothquant":
        assert tuple(got["layers"]["exp_down"]["smooth"].shape) == (L, E, tcfg.intermediate_size)


def _affine_close(case, got, want):
    """Leaves of one packed site: AWQ bit for bit; SmoothQuant's smooth within
    2 ulps and >= 99% of each other leaf's bytes equal."""
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "smooth":
            assert _ulps(g, w) <= 2, k
        elif case == "awq" or case == "rtn":
            _bits_equal(g, w)
        else:
            assert (g.view(np.uint8) == w.view(np.uint8)).mean() >= 0.99, k


def _sites(tree):
    sites = {k: v for k, v in tree["layers"].items() if isinstance(v, dict)}
    sites["lm_head"] = tree["lm_head"]
    return sites


def _site_layers(tree, key, expert, lm_head):
    """A packed site's leaf as a list of per-layer slices, [L, E, ...]
    expert leaves flattened layer-major (l0e0, l0e1, ...)."""
    a = np.asarray(tree[key])
    if lm_head:
        return [a]
    return list(a.reshape(-1, *a.shape[2:])) if expert else list(a)


def _dequant_affine(site, meta, layers_of):
    return [dequantize_parts(cpu(d), cpu(s), None if z is None else cpu(z), meta[0], meta[1],
                             torch.float32).numpy()
            for d, s, z in zip(layers_of("data"), layers_of("scales"),
                               layers_of("zeros") if "zeros" in site else
                               [None] * len(layers_of("data")))]


@pytest.mark.parametrize("case", ["rtn", "awq", "smoothquant", "smoothquant_a8", "gptq",
                                  "gptq_actorder", "pot", "apot"])
def test_pack_model_on_expert_sites_matches_qtpu(moe, case):
    """The same qmeta and leaves ([L, E, ...] on expert sites, the router
    dense), within each method's rule (module docstring)."""
    name, _, tcfg, p, _, _, js = moe
    pj, qj = _qtpu_pack(moe, case)
    pt, qt = _port_pack(moe, case)
    assert qt == qj and "router" not in dict(qt)
    want, got = _sites(jax.tree_util.tree_map(np.asarray, pj)), _sites(params_to_numpy(pt))
    assert set(got) == set(want)
    assert set(got["router"]) == {"w"}
    L, E = tcfg.num_layers, tcfg.num_experts
    meta = dict(qj)
    method = _method(case)
    for s, w in want.items():
        g = got[s]
        assert set(g) == set(w), s
        if s in tmoe.PACK_DENSE_SITES:
            _bits_equal(g["w"], w["w"])
            continue
        expert, head = s in tmoe.EXPERT_SITES, s == "lm_head"
        if expert:
            assert tuple(g["data"].shape[:2]) == (L, E), s
        if method in ("rtn", "awq", "smoothquant"):
            _affine_close(case, g, w)
            continue
        for k in w:
            assert np.asarray(g[k]).shape == np.asarray(w[k]).shape, (s, k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, (s, k)
        wl = (lambda key, t=w: _site_layers(t, key, expert, head))  # noqa: E731
        gl = (lambda key, t=g: _site_layers(t, key, expert, head))  # noqa: E731
        K, N = meta[s][2], meta[s][3]
        if method == "gptq":
            if "perm" in w:
                for a, b in zip(gl("perm"), wl("perm")):
                    np.testing.assert_array_equal(a, b)
            for a, b in zip(_dequant_affine(g, meta[s], gl), _dequant_affine(w, meta[s], wl)):
                assert (np.abs(a - b) <= 1e-6 * np.abs(b).max()).mean() >= 1 - MODEL_FLIPS, s
                assert _rel(a, b) < MODEL_W_TOL, s
            continue
        # pot / apot: the same level tables; groups equal but for ties and the window
        w0 = np.asarray(_sites(p)[s]["w"]).astype(np.float32)
        w0 = [w0] if head else list(w0.reshape(-1, K, N))
        for a, b in zip(gl("codebook"), wl("codebook")):
            np.testing.assert_array_equal(a, b)
        for wk, d, sc, cb, dj, sj, cbj in zip(w0, gl("data"), gl("scales"), gl("codebook"),
                                              wl("data"), wl("scales"), wl("codebook")):
            m4 = (4, G, K, N)
            deq = [k7.codebook_weight(cpu(x), cpu(y), cpu(z), m4, torch.float32).numpy()
                   for x, y, z in ((d, sc, cb), (dj, sj, cbj))]
            same = ((_cols(d.view(np.uint8), G // 2) == _cols(dj.view(np.uint8), G // 2)).all(1)
                    & (sc.view(np.uint16).T.reshape(-1) == sj.view(np.uint16).T.reshape(-1))
                    .reshape(N, K // G).T.reshape(-1))
            wg = _cols(wk, G)
            _check_groups(wg, _cols(deq[0], G), _cols(deq[1], G), _window_groups(wg), same)


@pytest.mark.parametrize("case", ["gptq", "gptq_actorder"])
def test_gptq_packed_codes_dequantized_are_quantize_models_weights(moe, case):
    """The reference of chip_smoke.py's moe_methods gate for GPTQ: pack_model's
    codes dequantized, actorder perms undone (chip_smoke._gptq_dense), are
    quantize_model's GPTQ weights at every site pack_model packs, within one
    bf16 ulp, on the true Hessians the smoke calibrates (the same column
    sweep on the same stats; the fake weight is made in f32 and rounded
    once, as dequantize_parts rounds it)."""
    import chip_smoke

    *_, pt, js = moe
    method, mcfg = _method(case), MCFG[case]
    st = _tstats(js, True)
    fake = tapply.quantize_model(pt, method, mcfg, st, "moe")
    packed, qmeta = tapply.pack_model(pt, method, mcfg, st, "moe")
    meta = dict(qmeta)
    sites = {s: v for s, v in _sites(packed).items() if "data" in v}
    assert set(sites) >= set(tmoe.EXPERT_SITES) | {"lm_head"}
    if case == "gptq_actorder":
        assert all("perm" in v for s, v in sites.items() if s != "lm_head")
    for s, v in sites.items():
        got = chip_smoke._gptq_dense(torch, v, meta[s])
        want = (fake["lm_head"] if s == "lm_head" else fake["layers"][s])["w"]
        assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, s
        gap = (got.float() - want.float()).abs()
        top = torch.maximum(got.float().abs(), want.float().abs())
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top).exponent - 8)
        assert bool((gap <= ulp).all()), (s, float(gap.max()), float((gap > 0).float().mean()))


@pytest.mark.parametrize("case", ["awq", "smoothquant_a8", "gptq_actorder", "pot", "apot"])
def test_packed_forward_matches_qtpu(moe, case):
    """forward on a packed MoE artifact (K9 on smoothed expert sites with a
    per-expert input, K6 / K1 with its perm / K7 one launch an expert, all
    through their plain versions here): qtpu's artifact through the port
    within 2e-2 of qtpu's forward on it, and the port's own artifact within
    2e-2 (3e-2 where the two packages' codes flip apart) of the same."""
    name, jcfg, tcfg, *_ = moe
    pj, qj = _qtpu_pack(moe, case)
    pt, qt = _port_pack(moe, case)
    ids = _batches(1, S=24, seed=12)[0].repeat(2, 0)
    want = np.asarray(jmoe.forward(pj, jnp.asarray(ids), jcfg, qmeta=qj))
    same_bytes = tmoe.forward(params_to_torch(jax.tree_util.tree_map(np.asarray, pj),
                                              device="cpu"), cpu(ids), tcfg, qmeta=qj)
    assert _rel(same_bytes.numpy(), want) < LOGIT_TOL
    tol = LOGIT_TOL if case == "awq" else FLIP_LOGIT_TOL
    assert _rel(tmoe.forward(pt, cpu(ids), tcfg, qmeta=qt).numpy(), want) < tol
    assert k9.moe_matmul.launches == 0


@pytest.mark.parametrize("case,B", [("awq", 1), ("awq", 2), ("smoothquant_a8", 1), ("pot", 1),
                                    ("gptq_actorder", 1)])
def test_decode_steps_match_qtpu(moe, case, B, monkeypatch):
    """qtpu's artifact through the port's and qtpu's forward_with_cache on
    the int8 cache: a prefill of 7 and 4 decode steps, each fed qtpu's
    greedy token and qtpu's cache as it stood (no step inherits the other
    package's roundings, such as the int8 codes that differ by up to 2,
    ROADMAP section 3), each step's logits within 2e-2 of qtpu's. (Greedy tokens are
    not compared: this random model's bf16 logits tie often, and a tie
    breaks on rounding.) On Mixtral at B = 1 (B * top_k < E) the AWQ
    artifact's smoothed expert sites take the gathered route (K10, each
    slot's row scaled by its expert's vector) and the other artifacts the
    grouped one, as in qtpu, where codebook and perm sites raise out of the
    gathered path and W8A8 ones are not affine."""
    name, jcfg, tcfg, *_ = moe
    pj, qj = _qtpu_pack(moe, case)
    pk = params_to_torch(jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    gathered, margins = [], []
    real, real_route = tmoe._moe_mlp_gathered, tmoe._route
    monkeypatch.setattr(tmoe, "_moe_mlp_gathered", lambda *a: gathered.append(1) or real(*a))

    def route(h, layers, cfg, qm, l):  # each row's logit gap between its k-th and (k+1)-th expert
        logits = tmoe.linear(h, layers["router"], qm("router"), layer=l).float()
        z = logits.sort(dim=-1, descending=True).values
        k = cfg.num_experts_per_tok
        margins.append((z[..., k - 1] - z[..., k]).reshape(-1))
        return real_route(h, layers, cfg, qm, l)

    monkeypatch.setattr(tmoe, "_route", route)
    ids = np.random.default_rng(40 + B).integers(0, tcfg.vocab_size, (B, 7)).astype(np.int32)
    pos = np.arange(7, dtype=np.int32)[None].repeat(B, 0)
    cj = jkv.init_cache(jcfg, B, 32, quantized=True)
    for step in range(5):
        ct = tkv.KVCache(*(cpu(np.asarray(a)) for a in
                           (cj.k, cj.v, cj.k_scale, cj.v_scale, cj.length)))
        margins.clear()
        lt, ct = tmoe.forward_with_cache(pk, cpu(ids), cpu(pos), ct, tcfg, qj)
        lj, cj = jmoe.forward_with_cache(pj, jnp.asarray(ids), jnp.asarray(pos), cj, jcfg, qj)
        # a row whose router nearly ties in some layer may route another way
        # in qtpu (ROADMAP section 3, MoE routing): held to 0.25 only
        T = ids.shape[1]
        tie = torch.stack(margins).reshape(len(margins), B, T).amin(dim=0) < TIE_MARGIN
        for b in range(B):
            for t in range(T):
                err = _rel(lt[b, t].numpy(), lj[b, t])
                assert err < (0.25 if tie[b, t] else LOGIT_TOL), (step, b, t, err)
        assert tie.float().mean() <= 0.5, (step, tie)
        ids = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)[:, None]
        pos = pos[:, -1:] + 1
    expect_gathered = name == "mixtral" and case == "awq" and B == 1
    assert len(gathered) == (4 * tcfg.num_layers if expect_gathered else 0)


# ------------------------------------------------------- bench and serve
def test_bench_runs_every_method_on_moe_with_qtpus_sizes(moe, tmp_path):
    """python -m qtpu_torch.bench's runner on tiny-moe-test: raw, rtn, awq,
    gptq, pot, apot and smoothquant with packed_eval and the serving
    pseudo-method on AWQ, no error row; every size equal to qtpu's
    accounting of the same params; the AWQ artifact saved and loaded back
    leaf for leaf. (Qwen2-MoE's sites take the same runner path.)"""
    from qtpu_torch.ckpt import load_quantized

    name, jcfg, _, _, pj, _, _ = moe
    if name != "mixtral":
        pytest.skip("one MoE config is enough for the runner")
    model = "tiny-moe-test"
    qc = {m: dict(MCFG[m], **({"nsamples": 4} if m == "gptq" else {}))
          for m in ("rtn", "awq", "gptq", "pot", "apot", "smoothquant")}
    bench = QuantizationBenchmark({
        "model_name": model, "quantization_methods": list(qc), "quantization_config": qc,
        "calibration_dataset": "synthetic", "test_dataset": "synthetic",
        "n_calibration_samples": 2, "calibration_block_size": 64, "n_test_samples": 2,
        "test_block_size": 64, "packed_eval": True, "verbose": False,
        "serving": {"benchmark": True, "pack_method": "awq", "max_batch_size": 2},
        "save_artifacts": {"dir": str(tmp_path / "art"), "method": "awq"},
    }, device="cpu")
    bench.run_all_benchmarks()
    res = bench.results
    assert set(res) == {"raw", *qc, "serving"}
    for m, r in res.items():
        assert r.is_success() and r.error is None, (m, r.error)
    for m, mc in qc.items():
        want = jax_model_size(pj, data_width=mc["w_bit"], group_size=mc["q_group_size"],
                              use_zero_point=m not in ("pot", "apot"))
        assert res[m].model_size_bits == want, m
        assert np.isfinite(res[m].packed_perplexity), m
    assert res["raw"].model_size_bits == jax_model_size(pj, data_width=32)
    assert res["serving"].tokens_per_second > 0
    packed, qmeta, _ = load_quantized(str(tmp_path / "art"), device="cpu")
    pk, qm = tapply.pack_model(bench.params, "awq", qc["awq"], bench.stats, arch="moe")
    assert qm == qmeta
    for path, a in jax.tree_util.tree_flatten_with_path(params_to_numpy(pk))[0]:
        b = dict(jax.tree_util.tree_flatten_with_path(params_to_numpy(packed))[0])[path]
        _bits_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("method,extra", [("awq", []), ("gptq", []), ("smoothquant", ["--a8"]),
                                          ("pot", [])])
def test_serve_cli_takes_every_method_on_moe(method, extra, capsys):
    """The serve CLI on tiny-moe-test with each method, one slot (decode on
    the gathered route where the sites allow), every request finished."""
    argv = ["--model", "tiny-moe-test", "--device", "cpu", "--kv", "int8", "--method", method,
            "--requests", "2", "--tokens", "3", "--batch", "1", *extra]
    assert serve_main(argv) == 0
    out = capsys.readouterr().out
    assert f"packed model with {method} W" in out and "2 requests, 6 tokens" in out
