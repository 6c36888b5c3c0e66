"""``arcle_tpu_torch.parallel`` against ``arcle_tpu.parallel``: the scaling
model, multi-process init and liveness, ``replicate``, the all-reduce
check and the block cut of ``shard_leading`` (sharded stepping and the dry
run: ``test_torch_parallel_sharding.py``; the learner's data and tensor
parallelism: ``test_torch_parallel_learner.py``).

Multi-rank cases run as Gloo process groups on the CPU: the rank function
below (``_alive_rank``) runs in fresh processes started by
``arcle_tpu_torch.parallel.launch`` (each call with its own timeout) and
imports no JAX; this module imports JAX only inside the tests that
compare with it.

The scaling model equals JAX's to 1e-12.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from arcle_tpu_torch.parallel import launch
from arcle_tpu_torch.parallel import rollout_worker as worker
from arcle_tpu_torch.parallel import scaling

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


# ---------------------------------------------------------------------------
# rank functions (run by arcle_tpu_torch.parallel.launch, no JAX)
# ---------------------------------------------------------------------------
def _alive_rank() -> None:
    """The liveness all-reduce, then ``replicate`` / ``replicate_global``
    of a tree and of a module whose values differ per rank."""
    import torch.distributed as dist
    from arcle_tpu_torch.parallel import (
        assert_all_processes_alive, make_mesh, replicate, replicate_global)
    assert_all_processes_alive(timeout_s=30.0)
    rank = dist.get_rank()
    mesh = make_mesh(device_type="cpu")
    tree = {"x": torch.arange(4) + 10 * rank,
            "m": (torch.tensor([rank == 0, rank == 1]),)}
    for fn in (replicate, replicate_global):
        out = fn(tree, mesh)
        assert torch.equal(out["x"], torch.arange(4)), out
        assert out["m"][0].tolist() == [True, False], out
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(rank)
    assert replicate(lin, mesh) is lin and float(lin.weight.abs().sum()) == 0
    print(f"ALIVE {rank} of {dist.get_world_size()}", flush=True)


# ---------------------------------------------------------------------------
# the scaling model
# ---------------------------------------------------------------------------
def _rows(times):
    return [{"devices": d, "iter_s": t}
            for d, t in zip((1, 2, 4, 8), times)]


@pytest.mark.parametrize("times", [
    0.10 + 0.05 * (np.array([1.0, 2.0, 4.0, 8.0]) - 1.0)
    / np.array([1.0, 2.0, 4.0, 8.0]),        # the model's own shape
    np.array([0.2, 1.0, 2.2, 9.6]),           # the contention fallback
], ids=["recovery", "contention"])
def test_fit_allreduce_matches(times):
    from arcle_tpu.parallel import scaling as jscaling
    want = jscaling.fit_allreduce(_rows(times))
    got = scaling.fit_allreduce(_rows(times))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n_params,period,hosts", [
    (1_960_022, 0.3484, (2, 4, 8, 16)), (2_000_000_000, 0.3484, (16,)),
    (1_960_022, 0.207, (2, 4, 8, 16))])
def test_project_multihost_matches(n_params, period, hosts):
    from arcle_tpu.parallel import scaling as jscaling
    assert scaling.DCN_BW == jscaling.DCN_BW
    for bw in (1e9, scaling.DCN_BW, 25e9):
        want = jscaling.project_multihost(n_params, period, hosts, bw)
        got = scaling.project_multihost(n_params, period, hosts, bw)
        for w, g in zip(want, got):
            assert w.keys() == g.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-12)


def test_flagship_n_params_matches():
    from arcle_tpu.parallel import scaling as jscaling
    assert scaling.flagship_n_params() == jscaling.flagship_n_params()


# ---------------------------------------------------------------------------
# multi-process init and liveness
# ---------------------------------------------------------------------------
def test_missing_peer_detected_at_init():
    """A process of a 2-process job whose peer never starts raises
    MultihostInitTimeout with the restart procedure, within the timeout
    (3 s) plus 20 s."""
    code = (
        "from arcle_tpu_torch.parallel import init_multihost, "
        "MultihostInitTimeout\n"
        "try:\n"
        f"    init_multihost('127.0.0.1:{launch.free_port()}', "
        "num_processes=2, process_id=0, timeout_s=3.0, device='cpu')\n"
        "except MultihostInitTimeout as e:\n"
        "    assert 'Restart the WHOLE job' in str(e), str(e)\n"
        "    print('DETECTED')\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], env=launch.rank_env(),
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    took = time.monotonic() - t0
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DETECTED" in out.stdout, out.stdout
    assert took < 3.0 + 20.0, took


def test_all_processes_alive_and_replicate_at_two_ranks():
    outs = launch.spawn(f"{HERE}:_alive_rank", 2, "cpu", timeout_s=120)
    assert "ALIVE 0 of 2" in outs[0] and "ALIVE 1 of 2" in outs[1], outs


def test_cuda_init_without_card_raises():
    from arcle_tpu_torch.parallel import init_multihost
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="NCCL does not fall back"):
        init_multihost("127.0.0.1:1", 1, 0)


def test_allreduce_model_validation():
    """A real 2-process Gloo all-reduce (the workers check every sum):
    positive times and a finite prediction.  The ratio's bound is not
    asserted: under several test workers it depends on timing."""
    out = scaling.validate_allreduce_model(500_000)     # a 2 MB gradient
    assert out["measured_s"] > 0 and min(out["probe_s"]) > 0, out
    assert out["grad_mb"] == pytest.approx(2.0)
    assert np.isfinite(out["ratio_pred_over_meas"]), out


def test_shard_leading_cuts_pool_rows_by_slot():
    """The single-process view of ``shard_block``: a pool's ``[B*K]`` rows
    and ``[B]`` counters cut to the same slots, the generator reseeded per
    block, undivided leaves whole."""
    from arcle_tpu_torch.parallel.mesh import shard_block
    env = worker.make_env("cpu")
    bs = env.reset(torch.Generator().manual_seed(0), worker.B)
    blocks = [shard_block(bs, 4, i) for i in range(4)]
    k = bs.pool.k
    for i, blk in enumerate(blocks):
        assert blk.batch == worker.B // 4 and blk.pool.k == k
        rows = slice(i * 8 * k, (i + 1) * 8 * k)
        assert torch.equal(blk.pool.grid, bs.pool.grid[rows])
        assert torch.equal(blk.env.grid, bs.env.grid[i * 8:(i + 1) * 8])
    seeds = {blk.generator.initial_seed() for blk in blocks}
    assert len(seeds) == 4
    assert shard_block(bs, 1, 0) is bs
    odd = shard_block({"x": torch.arange(6), "y": torch.arange(4)}, 4, 1)
    assert torch.equal(odd["x"], torch.arange(6))
    assert torch.equal(odd["y"], torch.tensor([1]))


def test_entry_points_default_to_the_card():
    import inspect
    from arcle_tpu_torch.parallel import dryrun, mesh, multihost
    for fn, arg in ((mesh.make_mesh, "device_type"),
                    (mesh.data_model_mesh, "device_type"),
                    (multihost.init_multihost, "device"),
                    (scaling.measure_ppo_scaling, "device"),
                    (scaling.scaling_report, "device"),
                    (dryrun.dryrun_multichip, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn


def test_parallel_imports_no_jax():
    code = ("import sys, arcle_tpu_torch.parallel.dryrun, "
            "arcle_tpu_torch.parallel.scaling, "
            "arcle_tpu_torch.parallel.rollout_worker, "
            "arcle_tpu_torch.parallel.psum_worker, "
            "arcle_tpu_torch.training.dt_bc; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'arcle_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], env=launch.rank_env(),
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
