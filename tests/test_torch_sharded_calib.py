"""The port's data-parallel calibration (qtpu_torch.calib.sharded) and its
multi-process entry (qtpu_torch.sharding.multihost) on the CPU.

One world of 2 gloo processes, joined by initialize_multihost from
explicit arguments (run_world of tests/test_torch_sharding.py): statistics
over data 2 (5 rows, so one padding row) and over data 1 x model 2,
against the single-process collect_calibration_stats on the same params: mean_abs and
max_abs bit for bit, the Hessians within 1e-5 relative (their sum order
differs); the partial-XᵀX all-reduce; the multihost summary and primary
rank. initialize_multihost in one process without arguments is a no-op.
"""

import numpy as np
import pytest
import torch

from qtpu_torch.models import config as tconfig
from test_torch_sharding import case, one_torch_thread, run_world  # noqa: F401  (a fixture)

CFG = tconfig.TINY_TEST
N_ROWS, BLOCK = 5, 32


def _stats(p, mesh_shape, hessian):
    from qtpu_torch.calib.sharded import collect_calibration_stats_sharded
    from qtpu_torch.models import llama
    from qtpu_torch.sharding.mesh import make_mesh

    mesh = make_mesh(*mesh_shape)
    st = collect_calibration_stats_sharded(llama.forward, p["params"], p["batches"], CFG, mesh,
                                           collect_hessian=hessian)
    return {"mean_abs": st.mean_abs, "max_abs": st.max_abs, "hessian": st.hessian,
            "n": st.n_batches}


def calib_worker(rank, world, p):
    from qtpu_torch.calib.sharded import psum_hessian
    from qtpu_torch.sharding.mesh import local_group, make_mesh
    from qtpu_torch.sharding.multihost import initialize_multihost, is_primary

    def partial():
        x = p["x"][rank::world]  # this rank's rows
        h = torch.einsum("rc,rd->rcd", x, x)
        return psum_hessian(h, local_group(make_mesh(data=2), "data"))

    return {"dp": lambda: _stats(p, (2, 1), True), "dp_tp": lambda: _stats(p, (1, 2), False),
            "psum": partial,
            "multihost": lambda: (initialize_multihost(), is_primary())}


@pytest.fixture(scope="module")
def setup():
    import jax

    from qtpu.models.config import TINY_TEST as J_TINY
    from qtpu.models.llama import init_params
    from qtpu_torch.convert import params_to_torch

    jp = init_params(J_TINY, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    return {
        "params": params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
        "batches": [rng.integers(0, 512, (1, BLOCK)).astype(np.int32) for _ in range(N_ROWS)],
        "x": torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory, setup):
    return run_world(tmp_path_factory, calib_worker, setup, n=2)


@pytest.fixture(scope="module")
def serial(setup):
    from qtpu_torch.calib import collect_calibration_stats
    from qtpu_torch.models import llama

    return collect_calibration_stats(llama.forward, setup["params"], setup["batches"], CFG,
                                     collect_hessian=True)


@pytest.mark.parametrize("name", ["dp", "dp_tp"])
@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_stats_equal_single_process(world, serial, name, rank):
    got = case(world, name, rank)
    assert got["n"] == N_ROWS
    assert set(got["mean_abs"]) == set(serial.mean_abs)
    for site in serial.mean_abs:
        assert got["mean_abs"][site].shape[0] == N_ROWS
        assert torch.equal(got["mean_abs"][site], serial.mean_abs[site]), site
        assert torch.equal(got["max_abs"][site], serial.max_abs[site]), site
        if got["hessian"] is not None:
            h, want = got["hessian"][site].double(), serial.hessian[site].double()
            assert float((h - want).norm() / want.norm()) < 1e-5, site


def test_psum_hessian_equals_the_whole_xtx(world, setup):
    x = setup["x"].double()
    want = (x.T @ x).float()
    for r in range(2):
        np.testing.assert_allclose(case(world, "psum", r).numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_initialize_multihost_two_processes(world):
    for r in range(2):
        info, primary = case(world, "multihost", r)
        assert info["process_index"] == r and info["process_count"] == 2
        assert info["global_devices"] == 2
        assert primary == (r == 0)


def test_initialize_multihost_is_a_noop_in_one_process(monkeypatch):
    import torch.distributed as dist

    from qtpu_torch.sharding.multihost import initialize_multihost, is_primary

    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    info = initialize_multihost()
    assert not dist.is_initialized()
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert is_primary()
