"""The plain PyTorch transition against the JAX package's XLA path.

Per field, per step: ``arcle_tpu_torch.ops.plain_step_deferred`` followed by
``finish_flood`` against ``jax.vmap(arcle_tpu.ops.step_deferred)`` followed
by ``finish_flood``, on the same states and the same actions, made from a
seed with numpy.  Integer state, the sparse reward, ``terminated`` and
``pending`` must be bit-exact.  The float32 shaped rewards (``dense_reward``,
``pixel_reward``) are compared with rtol=1e-6: XLA may fuse their float
operations in another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.core.state import Action as JAction, EnvState as JEnvState
from arcle_tpu.envs import BatchedEnv as JBatchedEnv
from arcle_tpu.envs import ResetOptions as JResetOptions
from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
from arcle_tpu import ops as jops
from arcle_tpu.ops.table import pixel_reward as jpixel_reward

from arcle_tpu_torch import ops as tops
from arcle_tpu_torch.core import Action, FIELDS, make_action, \
    state_from_numpy, state_to_numpy
from arcle_tpu_torch.testing import step_cases

B = 64

_vstep = jax.jit(jax.vmap(jops.step_deferred, in_axes=(0, 0, None)),
                 static_argnums=2)
_vfinish = jax.jit(jax.vmap(jops.finish_flood, in_axes=(0, 0, None, 0)),
                   static_argnums=2)
_vdense = jax.jit(jax.vmap(jops.dense_reward))
_vpixel = jax.jit(jax.vmap(jpixel_reward, in_axes=(0, None)),
                  static_argnums=1)

TABLES = {
    "o2arc": lambda m: (jops.o2arc_table(max_trial=m),
                        tops.o2arc_table(max_trial=m)),
    "o2arc_crop33": lambda m: (jops.o2arc_table(max_trial=m, crop_at_33=True),
                               tops.o2arc_table(max_trial=m,
                                                crop_at_33=True)),
    "arc": lambda m: (jops.arc_table(max_trial=m), tops.arc_table(max_trial=m)),
    "raw": lambda m: (jops.raw_table(max_trial=m), tops.raw_table(max_trial=m)),
}


def random_selection(rng, H=30, W=30):
    """Empty, single-pixel, box or sparse random 0/1 selection."""
    style = rng.integers(0, 4)
    sel = np.zeros((H, W), np.int8)
    if style == 1:
        sel[rng.integers(0, H), rng.integers(0, W)] = 1
    elif style == 2:
        x1, x2 = sorted(rng.integers(0, H, 2))
        y1, y2 = sorted(rng.integers(0, W, 2))
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    elif style == 3:
        sel[rng.random((H, W)) < 0.08] = 1
    return sel


def to_jax(np_state) -> JEnvState:
    return JEnvState(**{k: jnp.asarray(v) for k, v in np_state.items()})


def assert_states_equal(js, ts, what):
    tn = state_to_numpy(ts)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js, name)), tn[name],
                                      err_msg=f"{what} field {name}")


def step_both(jtable, ttable, jstate, tstate, sels, ops, what):
    """One step of both packages on the same actions, every output
    compared; returns the two new states and whether a flood was
    deferred."""
    jact = JAction(selection=jnp.asarray(sels), operation=jnp.asarray(ops))
    tact = Action(selection=torch.from_numpy(sels),
                  operation=torch.from_numpy(ops))

    js, jr, jt, jp = _vstep(jstate, jact, jtable)
    ts, tr, tt, tp = tops.plain_step_deferred(tstate, tact, ttable)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy(),
                                  err_msg=f"{what} pending")
    deferred = bool(np.asarray(jp).any())
    if deferred:
        js = _vfinish(js, jact, jtable, jp)
        ts = tops.finish_flood(ts, tact, ttable, tp)
    assert_states_equal(js, ts, what)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy(),
                                  err_msg=f"{what} reward")
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy(),
                                  err_msg=f"{what} terminated")
    H, W = ts.grid.shape[-2:]
    if (H, W) == (30, 30):      # dense_reward's domain: 30x30 or flat grids
        np.testing.assert_allclose(
            np.asarray(_vdense(js, jr)), tops.dense_reward(ts, tr).numpy(),
            rtol=1e-6, err_msg=f"{what} dense_reward")
    np.testing.assert_allclose(
        np.asarray(_vpixel(js, W)), tops.pixel_reward(ts, W).numpy(),
        rtol=1e-6, err_msg=f"{what} pixel_reward")
    return js, ts, deferred


def run_parity(jtable, ttable, jstate, rng, steps, pick_ops, what,
               select=random_selection):
    """Step both packages from ``jstate`` with the same actions."""
    tstate = state_from_numpy(jstate)
    assert_states_equal(jstate, tstate, f"{what} start")
    n_pending = 0
    for t in range(steps):
        ops = pick_ops(rng).astype(np.int32)
        sels = np.stack([select(rng) for _ in range(B)])
        jstate, tstate, deferred = step_both(jtable, ttable, jstate, tstate,
                                             sels, ops, f"{what} step {t}")
        n_pending += deferred
    return jstate, n_pending


def as_numpy(jstate):
    return {f.name: np.array(getattr(jstate, f.name))
            for f in dataclasses.fields(jstate)}


def fresh_states(jtable, seed, max_trial, reset_on_submit=False, H=30,
                 W=30):
    loader = JSyntheticLoader(8, seed=0, min_size=2, max_size=min(H, W, 12))
    env = JBatchedEnv(table=jtable, bank=loader.bank(H, W),
                      max_trial=max_trial,
                      opts=JResetOptions.make(reset_on_submit=reset_on_submit))
    return env.reset(jax.random.key(seed), B).env


@pytest.mark.parametrize("family", sorted(TABLES))
def test_plain_step_matches_xla(family):
    jtable, ttable = TABLES[family](3)
    rng = np.random.default_rng(11 + len(family))
    n_ops = jtable.n_ops
    run_parity(jtable, ttable, fresh_states(jtable, 1, 3), rng, 22,
               lambda r: r.integers(0, n_ops + 2, B) - 1, family)


def test_plain_step_reset_on_submit():
    """Submit-heavy actions with reset_on_submit: the re-init path."""
    jtable, ttable = TABLES["o2arc"](3)
    rng = np.random.default_rng(9)
    pick = lambda r: np.where(r.random(B) < 0.35, 34, r.integers(0, 35, B))
    run_parity(jtable, ttable, fresh_states(jtable, 2, 3, True), rng, 20,
               pick, "ros")


def test_plain_step_int8_wrap_and_off_grid_objects():
    """Trial counters near -128 and floating objects near the int8 limits
    of their position: int8 wraparound on the store and floor division of
    negative rotation anchors.  Object buffers hold values outside their
    patch too, so every cell of the transformed buffer is compared."""
    jtable, ttable = TABLES["o2arc"](3)
    rng = np.random.default_rng(5)
    st = as_numpy(fresh_states(jtable, 3, 3))
    st["trials_remain"] = rng.choice(
        np.array([-128, -127, -126, 1, 2, 0], np.int8), B)
    edge = np.array([-128, -127, -126, -100, -31, -2, -1, 0, 27, 29, 31,
                     100, 125, 126, 127], np.int8)
    st["object_pos"] = rng.choice(edge, (B, 2)).astype(np.int8)
    st["object_dim"] = rng.integers(1, 31, (B, 2)).astype(np.int8)
    st["active"] = (rng.random(B) < 0.8).astype(np.int8)
    st["rotation_parity"] = rng.integers(0, 2, B).astype(np.int8)
    st["object"] = rng.integers(0, 10, (B, 30, 30)).astype(np.int8)
    st["object_sel"] = (rng.random((B, 30, 30)) < 0.5).astype(np.int8)
    st["background"] = rng.integers(0, 10, (B, 30, 30)).astype(np.int8)

    def pick(r):
        # mostly object ops (20..27) and Submit, a few others
        obj = r.integers(20, 28, B)
        return np.where(r.random(B) < 0.15, 34,
                        np.where(r.random(B) < 0.8, obj, r.integers(0, 35, B)))

    def select(r):
        # mostly empty: the stored object keeps moving (the cont path)
        return np.zeros((30, 30), np.int8) if r.random() < 0.7 \
            else random_selection(r)

    run_parity(jtable, ttable, to_jax(st), rng, 20, pick, "wrap", select)


def test_deferred_flood_serpentine():
    """A flood whose component needs far more than FLOOD_UNROLL sweeps is
    pending after the step and exact after ``finish_flood``."""
    jtable, ttable = TABLES["o2arc"](3)
    g = np.full((30, 30), 2, np.int8)
    for r in range(0, 30, 2):
        g[r, :] = 1
    for i, r in enumerate(range(1, 29, 2)):
        g[r, 29 if i % 2 == 0 else 0] = 1
    st = as_numpy(fresh_states(jtable, 4, 3))
    st["grid"] = np.broadcast_to(g, (B, 30, 30)).copy()
    st["input"] = st["grid"].copy()
    st["grid_dim"] = np.full((B, 2), 30, np.int8)
    st["input_dim"] = st["grid_dim"].copy()
    jstate = to_jax(st)
    ops = np.full(B, 14, np.int32)          # FloodFill4
    sels = np.zeros((B, 30, 30), np.int8)
    sels[np.arange(B), 0, np.arange(B) % 30] = 1
    jact = JAction(selection=jnp.asarray(sels), operation=jnp.asarray(ops))
    tact = Action(selection=torch.from_numpy(sels),
                  operation=torch.from_numpy(ops))
    js, _, _, jp = _vstep(jstate, jact, jtable)
    ts, _, _, tp = tops.plain_step_deferred(state_from_numpy(st), tact,
                                            ttable)
    assert bool(tp.all()) and np.asarray(jp).all()
    js = _vfinish(js, jact, jtable, jp)
    ts = tops.finish_flood(ts, tact, ttable, tp)
    assert_states_equal(js, ts, "serpentine")
    assert (ts.grid.numpy() == np.where(g == 1, 4, 2)).all()


# (family, grid side): the four tables at 30x30, the 5x5 geometry of the
# answer-given suite, and a non-square raw-table geometry
ADVERSARIAL = {"o2arc": ("o2arc", 30, 30),
               "o2arc_crop33": ("o2arc_crop33", 30, 30),
               "arc": ("arc", 30, 30), "raw": ("raw", 30, 30),
               "o2arc_5x5": ("o2arc", 5, 5), "raw_12x20": ("raw", 12, 20)}


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_plain_step_adversarial(case):
    """The adversarial inputs the kernel is held to on the card (corridor
    floods seeded at their far end, int8 selections other than 0/1,
    object ops on envs holding an object, reset-on-submit rows), here
    through the plain path against the JAX package."""
    family, H, W = ADVERSARIAL[case]
    jtable, ttable = TABLES[family](3)
    rng = np.random.default_rng(21 + len(case))
    st = as_numpy(fresh_states(jtable, 5, 3, H=H, W=W))
    names = []
    for name, s0, acts in step_cases(st, ttable, rng, steps=3):
        js, ts = to_jax(s0), state_from_numpy(s0)
        for t, (sels, ops) in enumerate(acts):
            js, ts, _ = step_both(jtable, ttable, js, ts, sels, ops,
                                  f"{case} {name} step {t}")
        names.append(name)
    assert "odd_selections" in names and "reset_on_submit" in names


_vtransition = jax.jit(jax.vmap(jops.transition, in_axes=(0, 0, None)),
                       static_argnums=2)


def _serpentine_floods(jtable, rng):
    """Flood fills seeded on a serpentine corridor: components far longer
    than ``FLOOD_UNROLL`` sweeps reach."""
    g = np.full((30, 30), 2, np.int8)
    g[0::2, :] = 1
    for i, r in enumerate(range(1, 29, 2)):
        g[r, 29 if i % 2 == 0 else 0] = 1
    st = as_numpy(fresh_states(jtable, 4, 3))
    st["grid"] = np.broadcast_to(g, (B, 30, 30)).copy()
    st["grid_dim"] = np.full((B, 2), 30, np.int8)
    sels = np.zeros((B, 30, 30), np.int8)
    sels[np.arange(B), 0, np.arange(B) % 30] = 1
    return st, sels, rng.integers(10, 20, B)


TRANSITION_CASES = {
    "flood_unconverged": _serpentine_floods,
    "color": lambda jt, rng: (
        as_numpy(fresh_states(jt, 6, 3)),
        np.stack([random_selection(rng) for _ in range(B)]),
        rng.integers(0, 10, B)),
    "object": lambda jt, rng: (
        as_numpy(fresh_states(jt, 7, 3)),
        np.stack([random_selection(rng) for _ in range(B)]),
        rng.integers(20, 28, B)),
}


@pytest.mark.parametrize("case", sorted(TRANSITION_CASES))
def test_transition_matches_jax(case):
    """``ops.transition`` (the flood completed inline) against the JAX
    package's single-env ``transition`` over the batch, bit for bit; the
    corridor floods are pending after the unrolled sweeps."""
    jtable, ttable = TABLES["o2arc"](3)
    rng = np.random.default_rng(31 + len(case))
    st, sels, ops = TRANSITION_CASES[case](jtable, rng)
    ops = ops.astype(np.int32)
    tstate = state_from_numpy(st)
    tact = make_action(sels, ops, device="cpu")
    _, pending, _ = tops.transition_deferred(tstate, tact, ttable)
    assert bool(pending.all()) == (case == "flood_unconverged")
    want = _vtransition(to_jax(st), JAction(selection=jnp.asarray(sels),
                                            operation=jnp.asarray(ops)),
                        jtable)
    got = tops.transition(tstate, tact, ttable)
    assert_states_equal(want, got, case)
    assert not np.array_equal(state_to_numpy(got)["grid"], st["grid"])
    from arcle_tpu_torch import envs
    assert envs.transition is tops.transition and envs.step is tops.step


def test_make_action_matches_jax():
    """``core.make_action`` casts as the JAX package's does (int8 mask,
    int32 op, values wrapping); one mask makes a batch of one."""
    from arcle_tpu.core import make_action as jmake_action
    rng = np.random.default_rng(3)
    sel = rng.integers(-300, 300, (30, 30))
    op = np.int64(1 << 33 | 7)
    ja, ta = jmake_action(sel, op), make_action(sel, op, device="cpu")
    assert ta.selection.shape == (1, 30, 30) and ta.operation.shape == (1,)
    np.testing.assert_array_equal(ta.selection[0].numpy(),
                                  np.asarray(ja.selection))
    assert ta.selection.dtype == torch.int8
    assert int(ta.operation[0]) == int(ja.operation) == 7
    sels, ops = rng.integers(0, 2, (3, 30, 30)), np.array([3, 14, 34])
    tb = make_action(sels, ops, device="cpu")
    assert tb.operation.dtype == torch.int32
    np.testing.assert_array_equal(tb.selection.numpy(), sels)
    np.testing.assert_array_equal(tb.operation.numpy(), ops)
