"""The port's Gymnasium surface (``arcle_tpu_torch.envs.gym_compat``,
``envs.meta.CustomO2ARCEnv``, the wrappers, ``ARCLE-CUDA/*``).

On the CPU (``device="cpu"``): the port's ``O2ARCv2Env`` against
``arcle_tpu``'s ``O2ARCv2Env(backend="jax")`` (the slice as a whole
against the JAX package), ``CustomO2ARCEnv`` against ``arcle_tpu``'s with
the same seeds, the port's two backends against each other, registration,
spaces, wrappers, ANSI rendering byte for byte, and the adapters with
``gymnasium`` blocked.  Observations, rewards, ``terminated`` and the info
dict are compared bit for bit.  ``test_torch_gym_gpu.py`` holds the
card backend to the native one.
"""

import io
import os
import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest
import torch

from arcle_tpu.envs import O2ARCv2Env as JO2ARCv2Env
from arcle_tpu.envs.meta import CustomO2ARCEnv as JCustomO2ARCEnv
from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
from arcle_tpu.utils import render as jrender

import arcle_tpu_torch.envs  # noqa: F401  (registers ARCLE-CUDA/*)
from arcle_tpu_torch.envs import (
    ARCEnv, CustomO2ARCEnv, O2ARCNoFillEnv, O2ARCv2Env, RawARCEnv, GYM_IDS,
)
from arcle_tpu_torch.envs.gym_compat import _generator
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.utils import render as trender
from arcle_tpu_torch.wrappers import BBoxWrapper, FilterO2ARC, PointWrapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_action(rng, n_ops, t, side=30):
    """Every third step an empty selection, else a point or a box."""
    sel = np.zeros((side, side), np.int8)
    if t % 3 == 1:
        sel[rng.integers(0, side), rng.integers(0, side)] = 1
    elif t % 3 == 2:
        x1, x2 = sorted(rng.integers(0, side, 2).tolist())
        y1, y2 = sorted(rng.integers(0, side, 2).tolist())
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    return {"selection": sel, "operation": int(rng.integers(0, n_ops))}


def assert_obs_equal(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if k == "object_states":
            assert_obs_equal(got[k], v, f"{what} object_states")
            continue
        g, w = np.asarray(got[k]), np.asarray(v)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def assert_info_equal(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=f"{what} info {k}")


def run_pair(ours, ref, n_ops, steps, seed, side=30, reset_kw=None):
    """Reset both envs alike, then feed both the same random actions;
    compare obs, reward, terminated and info after the reset and after
    every step."""
    reset_kw = reset_kw or {}
    o_obs, o_info = ours.reset(**reset_kw)
    r_obs, r_info = ref.reset(**reset_kw)
    assert_obs_equal(o_obs, r_obs, "reset")
    assert_info_equal(o_info, r_info, "reset")
    rng = np.random.default_rng(seed)
    for t in range(steps):
        act = random_action(rng, n_ops, t, side)
        o_obs, o_r, o_term, o_trunc, o_info = ours.step(act)
        r_obs, r_r, r_term, r_trunc, r_info = ref.step(act)
        what = f"step {t} op {act['operation']}"
        assert (o_r, o_term, o_trunc) == (r_r, r_term, r_trunc), what
        assert_obs_equal(o_obs, r_obs, what)
        assert_info_equal(o_info, r_info, what)


def test_o2arc_matches_arcle_tpu_jax():
    """The slice as a whole: the port's adapter on the CPU against the JAX
    package's adapter stepping its jitted engine, 40 steps from pinned
    reset options, with a submit-limited trial counter."""
    opts = {"prob_index": 1, "subprob_index": 2, "adaptation": True}
    ours = O2ARCv2Env(data_loader=SyntheticLoader(4, seed=9), max_trial=3,
                      device="cpu")
    ref = JO2ARCv2Env(data_loader=JSyntheticLoader(4, seed=9), max_trial=3,
                      backend="jax")
    run_pair(ours, ref, 35, 40, seed=1,
             reset_kw=dict(seed=0, options=opts))
    assert ours.engine.state.grid.device.type == "cpu"


def test_custom_o2arc_matches_arcle_tpu():
    """CustomO2ARCEnv: CropGrid at 33, the augmentation drawn from
    np_random (same seed, same k and colour permutation), the dense
    reward, and the task API."""
    mk = lambda: dict(max_trial=7, augment=True, dense=True)
    ours = CustomO2ARCEnv(data_loader=SyntheticLoader(6, seed=4), **mk(),
                          device="cpu")
    ref = JCustomO2ARCEnv(data_loader=JSyntheticLoader(6, seed=4), **mk())
    assert ours.op_names[33] == "CropGrid" == ref.op_names[33]
    for env in (ours, ref):
        env.set_task(3)
    run_pair(ours, ref, 35, 30, seed=2, reset_kw=dict(seed=11))
    np.testing.assert_array_equal(ours.input_, ref.input_)
    np.testing.assert_array_equal(ours.answer, ref.answer)
    assert ours.get_task() == ref.get_task() == 3
    for env in (ours, ref):
        env.post_adaptation()
    run_pair(ours, ref, 35, 10, seed=3, reset_kw=dict(seed=12))
    for env in (ours, ref):
        env.init_adaptation()
    assert ours.reset_options == ref.reset_options


def test_native_matches_torch_cpu():
    """The adapter's two backends, step for step over 60 steps."""
    rng = np.random.default_rng(42)
    envs = [O2ARCv2Env(data_loader=SyntheticLoader(3, seed=9), backend=b,
                       device="cpu") for b in ("native", "torch")]
    obs = [e.reset(seed=0, options={"prob_index": 1, "subprob_index": 0})
           for e in envs]
    assert_obs_equal(obs[0][0], obs[1][0], "reset")
    for t in range(60):
        act = random_action(rng, 35, t)
        (o_n, r_n, t_n, _, i_n), (o_t, r_t, t_t, _, i_t) = \
            [e.step(act) for e in envs]
        assert (r_n, t_n) == (r_t, t_t), t
        assert_obs_equal(o_n, o_t, f"step {t}")
        assert_info_equal(i_n, i_t, f"step {t}")


def test_backends_and_devices():
    loader = SyntheticLoader(2, seed=1)
    with pytest.raises(ValueError, match="torch"):
        O2ARCv2Env(data_loader=loader, backend="jax")
    with pytest.raises(ValueError, match="backend"):
        O2ARCv2Env(data_loader=loader, backend="numpy", device="cpu")
    with pytest.raises(ValueError, match="square"):
        O2ARCv2Env(data_loader=loader, max_grid_size=(20, 30),
                   device="cpu")
    if torch.cuda.is_available():
        return
    for backend in ("auto", "torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            O2ARCv2Env(data_loader=loader, backend=backend)


def test_gym_make_every_id():
    loader = SyntheticLoader(4, seed=1)
    ids = [i for i, _, _ in GYM_IDS]
    assert len(ids) == 6 and all(i.startswith("ARCLE-CUDA/") for i in ids)
    for env_id in ids:
        env = gym.make(env_id, data_loader=loader, device="cpu")
        obs, info = env.reset(seed=0, options={"prob_index": 0,
                                               "subprob_index": 0})
        assert env.observation_space.contains(obs), env_id
        assert "answer" in info
        env.close()
    assert gym.spec("ARCLE-CUDA/O2ARCNoFillEnv").max_episode_steps == 300


@pytest.mark.parametrize("cls,n_ops", [(RawARCEnv, 12), (ARCEnv, 27),
                                       (O2ARCv2Env, 35),
                                       (O2ARCNoFillEnv, 25)])
def test_obs_space_contains_after_steps(cls, n_ops):
    env = cls(data_loader=SyntheticLoader(4, seed=2), max_trial=3,
              device="cpu")
    assert env.action_space["operation"].n == n_ops == len(env.operations)
    obs, _ = env.reset(seed=0, options={"prob_index": 0})
    rng = np.random.default_rng(0)
    for t in range(20):
        obs, r, term, trunc, info = env.step(random_action(rng, n_ops, t))
        assert env.observation_space.contains(obs), t
        if term:
            break


def test_wrappers_roundtrip():
    env = O2ARCv2Env(data_loader=SyntheticLoader(4, seed=3), max_trial=3,
                     device="cpu")
    wrapped = BBoxWrapper(env)
    obs, _ = wrapped.reset(seed=1, options={"prob_index": 0})
    obs, r, term, trunc, info = wrapped.step((2, 3, 0, 1, 4))
    assert (obs["grid"][0:3, 1:4] == 4).all()
    p = PointWrapper(O2ARCv2Env(data_loader=SyntheticLoader(4, seed=3),
                                max_trial=3, device="cpu"))
    obs, _ = p.reset(seed=1, options={"prob_index": 0})
    obs, *_ = p.step((2, 2, 7))
    assert obs["grid"][2, 2] == 7
    f = FilterO2ARC(env)
    fobs = f.observation(obs)
    assert list(fobs) == ["trials_remain", "grid", "grid_dim", "clip",
                          "clip_dim", "active", "object", "object_dim",
                          "object_pos"]
    assert f.observation_space.contains(fobs)


def test_nofill_table():
    env = O2ARCNoFillEnv(data_loader=SyntheticLoader(2, seed=4),
                         device="cpu")
    assert len(env.operations) == 25
    assert env.op_names[10] == "MoveU" and env.op_names[24] == "Submit"
    assert env.table.submit_op == 24


def test_ansi_render_matches_arcle_tpu(capsys):
    """Both painters give arcle_tpu's text byte for byte for the states
    the adapters reach, selection markers and clipboard included."""
    rng = np.random.default_rng(5)
    for cls, keys in ((RawARCEnv, ()), (O2ARCv2Env, ("clip", "selected"))):
        env = cls(data_loader=SyntheticLoader(2, seed=5),
                  render_mode="ansi", device="cpu")
        env.reset(seed=0, options={"prob_index": 0})
        assert capsys.readouterr().out.startswith("\033[2J")
        for t in range(6):
            act = random_action(rng, len(env.operations), t)
            if cls is O2ARCv2Env and t == 4:
                act["operation"] = 28                   # CopyI
            env.step(act)
            shown = capsys.readouterr().out
            args = (env.current_state, env.description,
                    env.op_names[env.last_action_op], env.last_reward)
            if keys:
                sel = bool(np.any(act["selection"]))
                ours = trender.render_ansi_o2(*args, sel, out=io.StringIO())
                ref = jrender.render_ansi_o2(*args, sel, out=io.StringIO())
            else:
                ours = trender.render_ansi_core(*args, out=io.StringIO())
                ref = jrender.render_ansi_core(*args, out=io.StringIO())
            assert ours == ref and shown == ref + "\n", (cls.__name__, t)
            assert "Problem Description" in shown and "\033[48;5;" in shown


_NO_GYM = """
import sys
sys.modules["gymnasium"] = None
import numpy as np
import arcle_tpu_torch
from arcle_tpu_torch import wrappers
from arcle_tpu_torch.envs import O2ARCv2Env, CustomO2ARCEnv
from arcle_tpu_torch.loaders import SyntheticLoader
import arcle_tpu_torch.training.train
assert not hasattr(wrappers, "BBoxWrapper")
env = O2ARCv2Env(data_loader=SyntheticLoader(3, seed=9), device="cpu")
assert env.observation_space is None and env.action_space is None
assert env.unwrapped is env
obs, info = env.reset(seed=7, options={"prob_index": 1})
sel = np.zeros((30, 30), np.int8)
sel[:2, :2] = 1
for op in (3, 20, 34):
    obs, r, term, trunc, info = env.step({"selection": sel, "operation": op})
env.close()
c = CustomO2ARCEnv(data_loader=SyntheticLoader(3, seed=9), device="cpu")
c.set_task(2)
c.reset(seed=5)
c.step({"selection": sel, "operation": 33})
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and m.split(".")[0] in ("jax", "arcle_tpu", "gymnasium"))
assert not bad, bad
print(env.subprob_index, int(obs["grid"].sum()), info["steps"],
      c.input_.tolist())
"""


def test_without_gymnasium():
    """With ``gymnasium`` blocked, the package and the training driver
    import, the adapters step on the CPU, and ``np_random`` gives the
    stream gymnasium gives for the same seed."""
    out = subprocess.run([sys.executable, "-c", _NO_GYM], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    env = O2ARCv2Env(data_loader=SyntheticLoader(3, seed=9), device="cpu")
    obs, info = env.reset(seed=7, options={"prob_index": 1})
    sel = np.zeros((30, 30), np.int8)
    sel[:2, :2] = 1
    for op in (3, 20, 34):
        obs, r, term, trunc, info = env.step({"selection": sel,
                                              "operation": op})
    c = CustomO2ARCEnv(data_loader=SyntheticLoader(3, seed=9), device="cpu")
    c.set_task(2)
    c.reset(seed=5)
    assert out.stdout.split(" ", 3) == [
        str(env.subprob_index), str(int(obs["grid"].sum())),
        str(info["steps"]), str(c.input_.tolist()) + "\n"]
    want = gym.utils.seeding.np_random(123)[0].integers(0, 1 << 30, 8)
    np.testing.assert_array_equal(_generator(123).integers(0, 1 << 30, 8),
                                  want)
