"""``arcle_tpu_torch.envs.BatchedEnv`` against ``arcle_tpu``'s
``BatchedEnv(use_pallas=False)``.

The two packages draw random numbers differently, so both start from the
same state and reset pool (carried across from the JAX package) or from
pinned task indices, and take the same actions, made from a seed with
numpy.  Carry, obs, terminated and truncated are bit-exact across
auto-resets, augmented ones included; the reward too, except for the
float32 shaped rewards (``dense_reward``, ``pixel_reward``), compared with
rtol=1e-6 because XLA may fuse their float operations in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.core.state import Action as JAction
from arcle_tpu.envs import BatchedEnv as JBatchedEnv
from arcle_tpu.envs import ResetOptions as JResetOptions
from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
from arcle_tpu.ops import o2arc_table as j_o2arc

from arcle_tpu_torch.core import Action, FIELDS, state_from_numpy
from arcle_tpu_torch.envs import BatchedEnv, ResetOptions, ResetPool
from arcle_tpu_torch.envs.core import BatchedState
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.ops import o2arc_table

B, STEPS = 64, 12
_jstep = jax.jit(JBatchedEnv.step)


def random_selection(rng):
    style = rng.integers(0, 4)
    sel = np.zeros((30, 30), np.int8)
    if style == 1:
        sel[rng.integers(0, 30), rng.integers(0, 30)] = 1
    elif style == 2:
        x1, x2 = sorted(rng.integers(0, 30, 2))
        y1, y2 = sorted(rng.integers(0, 30, 2))
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    elif style == 3:
        sel[rng.random((30, 30)) < 0.08] = 1
    return sel


def assert_env_equal(js, ts, what):
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy(),
                                      err_msg=f"{what} {name}")


def pinned_rows(rng):
    """Per-env pinned options: task, train pair, reset_on_submit."""
    return dict(prob_index=rng.integers(0, 8, B).astype(np.int32),
                subprob_index=rng.integers(0, 3, B).astype(np.int32),
                adaptation=np.ones(B, bool),
                reset_on_submit=rng.random(B) < 0.5)


def make_envs(pool, shaping, opts_rows):
    kw = dict(max_trial=3, episode_limit=5, auto_reset=True,
              reset_pool=2 if pool else 0, **shaping)
    jenv = JBatchedEnv(table=j_o2arc(max_trial=3),
                       bank=JSyntheticLoader(8, seed=0).bank(),
                       opts=JResetOptions(**{k: jnp.asarray(v)
                                             for k, v in opts_rows.items()}),
                       **kw)
    tenv = BatchedEnv(table=o2arc_table(max_trial=3),
                      bank=SyntheticLoader(8, seed=0).bank(device="cpu"),
                      opts=ResetOptions.make(**opts_rows, device="cpu"), **kw)
    return jenv, tenv


def test_reset_pinned_matches():
    """Pinned per-env indices: reset and the pool are deterministic, and
    equal in both packages."""
    rows = pinned_rows(np.random.default_rng(0))
    jenv, tenv = make_envs(True, {}, rows)
    jbs = jenv.reset(jax.random.key(0), B)
    tbs = tenv.reset(torch.Generator().manual_seed(0), B)
    assert_env_equal(jbs.env, tbs.env, "reset")
    for f in dataclasses.fields(tbs.pool):
        np.testing.assert_array_equal(np.asarray(getattr(jbs.pool, f.name)),
                                      getattr(tbs.pool, f.name).numpy(),
                                      err_msg=f"pool {f.name}")


CASES = {
    # drawn start and pool, carried across from the JAX package
    "pool": (True, {}),
    "pool_pixel": (True, {"pixel_reward": True}),
    # the train loop's env: augmented resets and pool, dense reward
    "pool_augment_dense": (True, {"augment": True, "dense_reward": True}),
    # pinned indices: auto-reset without a pool is deterministic
    "pinned_dense_match": (False, {"dense_reward": True,
                                   "terminate_on_match": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_env_matches(case):
    pool, shaping = CASES[case]
    rng = np.random.default_rng(len(case))
    if pool:
        rows = dict(prob_index=np.int32(-1), subprob_index=np.int32(-1),
                    adaptation=np.bool_(True),
                    reset_on_submit=rng.random(B) < 0.5)
    else:
        rows = pinned_rows(rng)
    jenv, tenv = make_envs(pool, shaping, rows)
    jbs = jenv.reset(jax.random.key(1), B)
    tpool = None
    if pool:
        tpool = ResetPool(**{f.name: torch.from_numpy(
            np.array(getattr(jbs.pool, f.name)))
            for f in dataclasses.fields(ResetPool)})
    tbs = BatchedState(env=state_from_numpy(jbs.env),
                       generator=torch.Generator().manual_seed(1),
                       pool=tpool)
    if not pool:
        assert_env_equal(jbs.env, tenv.reset(tbs.generator, B).env, "reset")
    float_reward = shaping.get("dense_reward") or shaping.get("pixel_reward")
    resets = 0
    for t in range(STEPS):
        ops = np.where(rng.random(B) < 0.1, 34,
                       rng.integers(0, 35, B)).astype(np.int32)
        sels = np.stack([random_selection(rng) for _ in range(B)])
        jbs, jobs, jr, jterm, jtrunc = _jstep(
            jenv, jbs, JAction(selection=jnp.asarray(sels),
                               operation=jnp.asarray(ops)))
        tbs, tobs, tr, tterm, ttrunc = tenv.step(
            tbs, Action(selection=torch.from_numpy(sels),
                        operation=torch.from_numpy(ops)))
        what = f"{case} step {t}"
        assert_env_equal(jobs, tobs, f"{what} obs")
        assert_env_equal(jbs.env, tbs.env, f"{what} carry")
        np.testing.assert_array_equal(np.asarray(jterm), tterm.numpy(),
                                      err_msg=f"{what} term")
        np.testing.assert_array_equal(np.asarray(jtrunc), ttrunc.numpy(),
                                      err_msg=f"{what} trunc")
        if float_reward:
            np.testing.assert_allclose(np.asarray(jr), tr.numpy(), rtol=1e-6,
                                       err_msg=f"{what} reward")
        else:
            np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                          err_msg=f"{what} reward")
        if pool:
            np.testing.assert_array_equal(np.asarray(jbs.pool.counter),
                                          tbs.pool.counter.numpy(),
                                          err_msg=f"{what} pool counter")
        resets += int((tterm | ttrunc).sum())
    assert resets >= B            # every env truncated at least once


def test_entry_points_default_to_the_card():
    """Banks and reset options are made on the card unless the caller asks
    for another device; the env's default options follow its bank."""
    import inspect
    from arcle_tpu_torch.loaders import Loader, bake_bank
    for fn in (bake_bank, Loader.bank, ResetOptions.make):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    env = BatchedEnv(table=o2arc_table(),
                     bank=SyntheticLoader(2, seed=0).bank(device="meta"))
    for f in dataclasses.fields(env.opts):
        assert getattr(env.opts, f.name).device.type == "meta", f.name
