"""Sharded stepping and the multi-rank dry run (``arcle_tpu_torch.parallel.
rollout_worker``, ``arcle_tpu_torch.parallel.dryrun``) on Gloo ranks of
the CPU, against ``arcle_tpu``'s unsharded ``BatchedEnv``.

The ranks run in fresh processes (each call with its own timeout) and
import no JAX; this module imports JAX inside the tests, so the JAX side
runs in the test process and data crosses over as ``.npz`` files.  Env
states, pool counters, rewards and flags are bit-exact.
"""

import sys

import numpy as np
import pytest

from arcle_tpu_torch.parallel import launch
from arcle_tpu_torch.parallel import rollout_worker as worker


# ---------------------------------------------------------------------------
# sharded stepping
# ---------------------------------------------------------------------------
def _worker_cmds(n, *extra):
    port = str(launch.free_port())
    return [[sys.executable, "-m", "arcle_tpu_torch.parallel.rollout_worker",
             str(r), str(n), port, "--device", "cpu", *extra]
            for r in range(n)]


def _checksums(outs):
    vals = set()
    for out in outs:
        for line in out.splitlines():
            if line.startswith("CHECKSUM "):
                vals.add(int(line.rsplit("value=", 1)[1]))
    return vals


def test_sharded_stepping_matches_jax(tmp_path):
    """2 ranks step a pooled O2ARCv2 batch (auto-resets from the pool
    included); the gathered state, pool counters, rewards and flags equal
    JAX's unsharded ``BatchedEnv`` from the same state, pool and
    actions."""
    import jax
    import jax.numpy as jnp
    from arcle_tpu.core.state import Action as JAction
    from arcle_tpu.envs import BatchedEnv as JBatchedEnv
    from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
    from arcle_tpu.ops import o2arc_table as j_o2arc
    from arcle_tpu_torch.core import FIELDS

    jenv = JBatchedEnv(table=j_o2arc(max_trial=3),
                       bank=JSyntheticLoader(6, seed=0).bank(), max_trial=3,
                       episode_limit=5, auto_reset=True,
                       reset_pool=worker.POOL)
    jbs = jenv.reset(jax.random.key(0), worker.B)
    sel, ops = worker.bbox_actions(seed=3)
    state = {k: np.asarray(getattr(jbs.env, k)) for k in FIELDS}
    state.update({f"pool_{f}": np.asarray(getattr(jbs.pool, f))
                  for f in ("grid", "dim", "answer", "answer_dim",
                            "counter")})
    np.savez(tmp_path / "in.npz", selection=sel, operation=ops, **state)
    launch.run_commands(_worker_cmds(2, "--state", str(tmp_path / "in.npz"),
                                     "--out", str(tmp_path / "out.npz")),
                        timeout_s=240)
    got = np.load(tmp_path / "out.npz")

    step = jax.jit(JBatchedEnv.step)
    rews, terms, truncs = [], [], []
    for s in range(len(ops)):
        jbs, _o, r, term, trunc = step(jenv, jbs, JAction(
            selection=jnp.asarray(sel[s]), operation=jnp.asarray(ops[s])))
        rews.append(np.asarray(r))
        terms.append(np.asarray(term))
        truncs.append(np.asarray(trunc))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jbs.env, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(got["pool_counter"],
                                  np.asarray(jbs.pool.counter))
    for name, want in (("step_reward", rews), ("step_terminated", terms),
                       ("step_truncated", truncs)):
        np.testing.assert_array_equal(got[name], np.stack(want),
                                      err_msg=name)
    assert np.asarray(jbs.pool.counter).min() >= 1     # every env reset


def test_rollout_worker_checksum_two_ranks_equals_one():
    one = _checksums(launch.run_commands(_worker_cmds(1), timeout_s=240))
    two = _checksums(launch.run_commands(_worker_cmds(2), timeout_s=240))
    assert len(one) == 1 and two == one, (one, two)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
def test_dryrun_multichip_four_ranks():
    """``dryrun_multichip(4, device="cpu")`` without its scaling report:
    (data=2, model=2), a finite loss, the TP placement before and after the
    update, 2 envs per rank (the ranks assert them)."""
    from arcle_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4, device="cpu", report=False)
    assert np.isfinite(out["loss"]) and out["envs_per_rank"] == 2, out
    assert out["launches"] == 0          # the CPU takes the plain step


@pytest.mark.slow
def test_dryrun_multichip_with_scaling_report(capsys):
    """The whole of ``python -m arcle_tpu_torch.parallel.dryrun --n 4
    --device cpu``, the scaling sweep over 1, 2 and 4 ranks included
    (about 75 s alone)."""
    from arcle_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")
    text = capsys.readouterr().out
    assert "one sharded PPO step OK" in text
    assert "ranks=4 (gloo, cpu)" in text and "model projection" in text
