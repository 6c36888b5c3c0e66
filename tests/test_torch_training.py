"""The port's PPO learner against ``arcle_tpu``'s, and its entry point.

Both packages run the train loop's env (CropGrid at op 33, augmentation,
dense reward) at a small size: hidden=(32, 32), B=8, T=8,
episode_limit=4 (so episodes truncate inside the rollout), max_trial=3.
The two packages draw random numbers differently, so the port is handed
what JAX draws: the start state, the reset pool each rollout refreshes,
the sampling noise and the minibatch permutations.  Weights and the Adam
state cross over through ``arcle_tpu_torch.models.convert``.

Integer results are bit-exact; float results carry the tolerance stated at
each test (XLA and PyTorch sum in other orders).
"""

import dataclasses
import functools
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.envs import BatchedEnv as JBatchedEnv
from arcle_tpu.envs import reset_jit as j_reset_jit
from arcle_tpu.envs.core import make_reset_pool as j_make_reset_pool
from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
from arcle_tpu.models.mlp import FCPolicy as JFCPolicy
from arcle_tpu.ops import o2arc_table as j_o2arc
from arcle_tpu.wrappers import flatten_obs as j_flatten_obs
from arcle_tpu_torch.core import FIELDS, state_from_numpy
from arcle_tpu_torch.envs import BatchedEnv, ResetPool, random_bbox_actions
from arcle_tpu_torch.envs.core import BatchedState
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.models import (
    FCPolicy, fcpolicy_state_dict_from_flax, adam_state_from_optax,
)
from arcle_tpu_torch.ops import o2arc_table
from arcle_tpu_torch.utils import Checkpointer

# the packages' ``training`` re-exports a function named ``rollout``, which
# hides the submodule from ``from ... import``
jagents, jppo, jroll = (importlib.import_module(f"arcle_tpu.training.{m}")
                        for m in ("agents", "ppo", "rollout"))
tagents, tppo, troll, ttrain = (
    importlib.import_module(f"arcle_tpu_torch.training.{m}")
    for m in ("agents", "ppo", "rollout", "train"))
tmlp = importlib.import_module("arcle_tpu_torch.models.mlp")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, HIDDEN = 8, 8, (32, 32)
ENV_KW = dict(max_trial=3, episode_limit=4, auto_reset=True,
              dense_reward=True, augment=True, reset_pool=2)

_jrollout = jax.jit(jroll.rollout, static_argnums=(4, 5, 6))
_jtrain_step = jax.jit(jppo.train_step, static_argnums=(4, 5, 6))
_jpool = jax.jit(j_make_reset_pool, static_argnums=(2,))


def to_torch(x):
    return torch.tensor(np.asarray(x))


def close(actual, desired, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(
        actual.detach().cpu().numpy() if torch.is_tensor(actual) else actual,
        np.asarray(desired), rtol=rtol, atol=atol, err_msg=what)


def exact(actual, desired, what=""):
    np.testing.assert_array_equal(actual.cpu().numpy(), np.asarray(desired),
                                  err_msg=what)


def flax_to_state(params):
    return fcpolicy_state_dict_from_flax(jax.tree.map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def slice_run(deterministic: bool):
    """The same rollout in both packages, from JAX's start state, with
    JAX's pool refresh (and, when sampling, JAX's uniforms) injected."""
    jenv = JBatchedEnv(table=j_o2arc(3, crop_at_33=True),
                       bank=JSyntheticLoader(6, seed=0).bank(), **ENV_KW)
    tenv = BatchedEnv(table=o2arc_table(3, crop_at_33=True),
                      bank=SyntheticLoader(6, seed=0).bank(device="cpu"),
                      **ENV_KW)
    jpol = JFCPolicy(hidden=HIDDEN, n_ops=35)
    jagent = jagents.mlp_agent(jpol)
    jbs = j_reset_jit(jenv, jax.random.key(0), B)
    params = jagent.init_fn(jax.random.key(1), j_flatten_obs(jbs.env))
    key = jax.random.key(2)
    jbs2, jtraj, jlast = _jrollout(jenv, jbs, params, key, T, jagent,
                                   deterministic)

    # what JAX's rollout draws from ``key``: the pool, then one key per step
    key, kp = jax.random.split(key)
    jpool = _jpool(jenv, kp, B)
    us = []
    for _ in range(T):
        key, ka = jax.random.split(key)
        us.append(to_torch(jax.random.uniform(ka, (B, 5, 35), minval=1e-12,
                                              maxval=1.0)))
    pool = ResetPool(**{f.name: to_torch(getattr(jpool, f.name))
                        for f in dataclasses.fields(ResetPool)})
    noise = iter(us)

    tpol = FCPolicy(hidden=HIDDEN, n_ops=35)
    tpol.load_state_dict(flax_to_state(params))
    tagent = tagents.mlp_agent(tpol)
    tbs = BatchedState(env=state_from_numpy(jbs.env),
                       generator=torch.Generator().manual_seed(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(troll, "make_reset_pool", lambda env, gen, batch: pool)
        mp.setattr(tmlp, "gumbel_uniforms",
                   lambda shape, gen, device: next(noise))
        tbs2, ttraj, tlast = troll.rollout(tenv, tbs, tpol, None, T, tagent,
                                           deterministic)
    return dict(jagent=jagent, params=params, jbs=jbs2, jtraj=jtraj,
                jlast=jlast, tagent=tagent, tpol=tpol, tbs=tbs2, ttraj=ttraj,
                tlast=tlast)


@pytest.mark.parametrize("deterministic", [True, False],
                         ids=["deterministic", "sampled"])
def test_rollout_matches(deterministic):
    """obs, actions, dones, terminated and the final carry bit-exact;
    rewards rtol 1e-6; log-probs, values, final values and the last value
    rtol 1e-5, atol 1e-6."""
    r = slice_run(deterministic)
    jt, tt = r["jtraj"], r["ttraj"]
    for name in ("obs", "actions", "dones", "terminated"):
        exact(getattr(tt, name), getattr(jt, name), name)
    assert tt.obs.dtype == torch.int8 and tt.obs.shape == (T, B, 2710)
    close(tt.rewards, jt.rewards, 1e-6, what="rewards")
    for name in ("log_probs", "values", "final_values"):
        close(getattr(tt, name), getattr(jt, name), 1e-5, 1e-6, name)
    close(r["tlast"], r["jlast"], 1e-5, 1e-6, "last_value")
    for name in FIELDS:
        exact(getattr(r["tbs"].env, name), getattr(r["jbs"].env, name),
              f"carry {name}")
    exact(r["tbs"].pool.counter, r["jbs"].pool.counter, "pool counter")
    # the limit truncated episodes inside the rollout, and only truncations
    # that did not terminate bootstrap
    need = tt.dones & ~tt.terminated
    assert bool(need.any())
    assert bool((tt.final_values[need] != 0).all())
    assert bool((tt.final_values[~need] == 0).all())


def test_decoded_actions_are_dense():
    """``decode_bbox_actions`` builds the BBoxWrapper selection, and its
    tensors are contiguous, as the step kernel requires."""
    acts = torch.tensor([[1, 2, 0, 4, 7], [3, 3, 3, 3, 34]], dtype=torch.int32)
    a = troll.decode_bbox_actions(acts)
    assert a.operation.is_contiguous() and a.selection.is_contiguous()
    assert a.operation.tolist() == [7, 34]
    expect = np.zeros((2, 30, 30), np.int8)
    expect[0, 0:2, 2:5] = 1
    expect[1, 3, 3] = 1
    exact(a.selection, expect)


def test_batch_matches():
    """``batch_from_trajectory``: obs and actions bit-exact, normalised
    advantages and returns rtol 1e-5, atol 1e-6."""
    r = slice_run(False)
    cfg = jppo.PPOConfig()
    jb = jppo.batch_from_trajectory(r["jtraj"], r["jlast"], cfg)
    tb = tppo.batch_from_trajectory(r["ttraj"], r["tlast"],
                                    tppo.PPOConfig())
    exact(tb.obs, jb.obs, "obs")
    exact(tb.actions, jb.actions, "actions")
    for name in ("log_probs", "values", "advantages", "returns"):
        close(getattr(tb, name), getattr(jb, name), 1e-5, 1e-6, name)
    # the aux targets (used by agents with aux_fn) match too
    jx = jppo.batch_from_trajectory(r["jtraj"], r["jlast"], cfg,
                                    include_aux=True, grid_slice=slice(1, 901))
    tx = tppo.batch_from_trajectory(r["ttraj"], r["tlast"], tppo.PPOConfig(),
                                    include_aux=True, grid_slice=slice(1, 901))
    exact(tx.next_grid, jx.next_grid, "next_grid")
    for name in ("rewards", "prev_rewards", "aux_valid"):
        close(getattr(tx, name), getattr(jx, name), 1e-6, what=name)


LEARNER_CASES = {
    "full": {},
    "full_clip": {"max_grad_norm": 1e-2},
    "minibatch": {"n_epochs": 2, "n_minibatches": 2},
    "minibatch_clip": {"n_epochs": 2, "n_minibatches": 2,
                       "max_grad_norm": 1e-2},
}


# the policy loss and the KL estimate are means of terms of order 1 that
# cancel to about 1e-3: float32 leaves them an absolute error of ~1e-7 per
# term, which rtol alone cannot take
STAT_ATOL = 1e-6


def torch_batch(jb):
    return tppo.PPOBatch(**{k: to_torch(v) for k, v in jb._asdict().items()
                            if v is not None})


@pytest.mark.parametrize("case", sorted(LEARNER_CASES))
def test_learner_matches(case):
    """From a state after one JAX update (weights and Adam state carried
    across): loss and stats rtol 1e-5 (atol 1e-6, see STAT_ATOL),
    gradients rtol 1e-4 / atol 1e-6, the stats of ``train_step`` as the
    loss, and the params after it atol 1e-5.  The clip triggers in the
    ``_clip`` cases only."""
    r = slice_run(False)
    kw = LEARNER_CASES[case]
    jcfg, tcfg = jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)
    jagent, tagent = r["jagent"], r["tagent"]
    jb = jppo.batch_from_trajectory(r["jtraj"], r["jlast"], jcfg)
    tb = torch_batch(jb)
    tx = jppo.make_optimizer(jcfg)
    p1, o1, _ = _jtrain_step(r["params"], tx.init(r["params"]), jb,
                             jax.random.key(5), jagent, tx, jcfg)

    pol = FCPolicy(hidden=HIDDEN, n_ops=35)
    pol.load_state_dict(flax_to_state(p1))
    opt = tppo.make_optimizer(pol, tcfg)
    opt.state.update(adam_state_from_optax(o1, pol))

    # loss, stats and gradients at p1
    (jloss, jstats), jgrads = jax.value_and_grad(
        jppo.ppo_loss, has_aux=True)(p1, jagent, jb, jcfg)
    tloss, tstats = tppo.ppo_loss(pol, tagent, tb, tcfg)
    tloss.backward()
    close(tloss, jloss, 1e-5, STAT_ATOL, "loss")
    for k in jstats:
        close(tstats[k], jstats[k], 1e-5, STAT_ATOL, k)
    jg = flax_to_state(jgrads)
    for name, p in pol.named_parameters():
        close(p.grad, jg[name], 1e-4, 1e-6, f"grad {name}")
    norm = float(np.sqrt(sum(float(jnp.sum(g * g))
                             for g in jax.tree.leaves(jgrads))))
    assert (norm > jcfg.max_grad_norm) == case.endswith("_clip")

    # one train_step from p1, with JAX's permutations injected
    key = jax.random.key(6)
    n = jb.obs.shape[0]
    perms = [to_torch(jax.random.permutation(ek, n)).long()
             for ek in jax.random.split(key, jcfg.n_epochs)]
    p2, _, jst = _jtrain_step(p1, o1, jb, key, jagent, tx, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tppo, "permutations", lambda gen, e, n_, dev: perms)
        tst = tppo.train_step(pol, opt, tb, None, tagent, tcfg)
    assert set(tst) == set(jst)
    for k in jst:
        close(tst[k], jst[k], 1e-5, STAT_ATOL, f"train_step {k}")
    for name, v in flax_to_state(p2).items():
        close(pol.state_dict()[name], v, 0, 1e-5, f"param {name}")


def test_gae_matches():
    """Random trajectories with truncations and terminations: the port's
    GAE against JAX's, with and without the truncation bootstrap,
    rtol 1e-5 / atol 1e-6 (the recursion compounds rounding over T)."""
    rng = np.random.default_rng(0)
    Tn, Bn = 12, 16
    term = rng.random((Tn, Bn)) < 0.1
    dones = term | (rng.random((Tn, Bn)) < 0.15)
    fv = np.where(dones & ~term, rng.standard_normal((Tn, Bn)), 0)
    arrays = dict(
        obs=np.zeros((Tn, Bn, 1), np.int8),
        actions=np.zeros((Tn, Bn, 5), np.int32),
        log_probs=np.zeros((Tn, Bn), np.float32),
        values=rng.standard_normal((Tn, Bn)).astype(np.float32),
        rewards=rng.standard_normal((Tn, Bn)).astype(np.float32),
        dones=dones, terminated=term, final_values=fv.astype(np.float32))
    last = rng.standard_normal(Bn).astype(np.float32)
    jt = jroll.Trajectory(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tt = troll.Trajectory(**{k: torch.tensor(v) for k, v in arrays.items()})
    for boot in (True, False):
        ja, jr = jroll.gae(jt, jnp.asarray(last), 0.9, 0.8, boot)
        ta, tr = troll.gae(tt, torch.tensor(last), 0.9, 0.8, boot)
        close(ta, ja, 1e-5, 1e-6, f"adv boot={boot}")
        close(tr, jr, 1e-5, 1e-6, f"ret boot={boot}")


def hand_traj(values, rewards, dones, term, fvals):
    col = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt).view(-1, 1)
    n = len(values)
    return troll.Trajectory(
        obs=torch.zeros((n, 1, 1), dtype=torch.int8),
        actions=torch.zeros((n, 1, 5), dtype=torch.int32),
        log_probs=torch.zeros((n, 1)), values=col(values),
        rewards=col(rewards), dones=col(dones, torch.bool),
        terminated=col(term, torch.bool), final_values=col(fvals))


def test_gae_hand_recursion():
    """The closed-form recursions of ``tests/test_training.py``: a
    trajectory with no done, and one with a truncation (final value 7) at
    t=1 and a termination at t=3; rtol 1e-5."""
    gamma, lam = 0.9, 0.8
    traj = hand_traj([1., 2., 3., 4.], [1.] * 4, [0] * 4, [0] * 4, [0.] * 4)
    adv, _ = troll.gae(traj, torch.tensor([5.]), gamma, lam)
    expect, nxt, v_next = np.zeros(4), 0.0, 5.0
    for t in reversed(range(4)):
        nxt = 1.0 + gamma * v_next - (t + 1.0) + gamma * lam * nxt
        expect[t], v_next = nxt, t + 1.0
    close(adv[:, 0], expect, 1e-5)

    dones, fvals = [0, 1, 0, 1, 0], [0., 7., 0., 0., 0.]
    traj = hand_traj([1., 2., 3., 4., 5.], [1.] * 5, dones,
                     [0, 0, 0, 1, 0], fvals)
    adv, ret = troll.gae(traj, torch.tensor([6.]), gamma, lam,
                         bootstrap_truncation=True)
    expect, nxt, v_next = np.zeros(5), 0.0, 6.0
    for t in reversed(range(5)):
        d = dones[t]
        delta = 1.0 + gamma * (v_next * (1 - d) + fvals[t]) - (t + 1.0)
        nxt = delta + gamma * lam * (1 - d) * nxt
        expect[t], v_next = nxt, t + 1.0
    close(adv[:, 0], expect, 1e-5)
    close(ret[:, 0], expect + np.arange(1, 6), 1e-5)
    adv0, _ = troll.gae(traj, torch.tensor([6.]), gamma, lam,
                        bootstrap_truncation=False)
    assert abs(float(adv0[1, 0]) - (1.0 - 2.0 + gamma * 7.0)) > 1.0


def test_poolless_augmented_reset():
    """Without a pool, auto-reset draws fresh augmented pairs: every fresh
    grid and answer is a rot90^k recolouring (one shared colour bijection)
    of a bank pair, with the dims swapped for odd k, and the grid is zero
    outside its dims."""
    bank = SyntheticLoader(6, seed=0).bank(device="cpu")
    env = BatchedEnv(table=o2arc_table(3, crop_at_33=True), bank=bank,
                     max_trial=3, episode_limit=2, auto_reset=True,
                     augment=True)
    n = 32
    bs = env.reset(torch.Generator().manual_seed(0), n)
    gen = torch.Generator().manual_seed(1)
    fresh = []
    for _ in range(4):
        a = random_bbox_actions(gen, n, 35, 30, 30, "cpu")
        bs, _, _, term, trunc = env.step(bs, a)
        done = (term | trunc).nonzero()[:, 0].tolist()
        fresh += [(bs.env.grid[i].numpy(), bs.env.grid_dim[i].numpy(),
                   bs.env.answer[i].numpy(), bs.env.answer_dim[i].numpy())
                  for i in done]
    assert len(fresh) >= n
    pairs = [(bank.in_grids[p].numpy(), bank.in_dims[p].numpy(),
              bank.out_grids[p].numpy(), bank.out_dims[p].numpy())
             for p in range(bank.n_pairs)]
    ks = set()
    for grid, dim, answer, adim in fresh:
        h, w = dim
        assert not grid[h:].any() and not grid[:, w:].any()
        ks.add(_explain(grid[:h, :w], answer[:adim[0], :adim[1]], pairs))
    # every rotation occurs (the shape match checks the swapped dims)
    assert ks == {0, 1, 2, 3}


def _explain(grid, answer, pairs):
    """The k of some bank pair that ``(grid, answer)`` is a rotated,
    recoloured copy of; fails when there is none."""
    for g0, d0, a0, ad0 in pairs:
        for k in range(4):
            src = np.rot90(g0[:d0[0], :d0[1]], k)
            asrc = np.rot90(a0[:ad0[0], :ad0[1]], k)
            if src.shape != grid.shape or asrc.shape != answer.shape:
                continue
            pairs_cv = np.concatenate([
                np.stack([src.ravel(), grid.ravel()], 1),
                np.stack([asrc.ravel(), answer.ravel()], 1)])
            mapping = {}
            ok = True
            for c, v in pairs_cv:
                if mapping.setdefault(int(c), int(v)) != v:
                    ok = False
                    break
            if ok and len(set(mapping.values())) == len(mapping):
                return k
    raise AssertionError("a fresh grid is no augmentation of a bank pair")


def smoke_args(tmp_path, *extra):
    return ["--algo", "ppo", "--smoke", "--device", "cpu",
            "--log-file", str(tmp_path / "log.jsonl"),
            "--ckpt-dir", str(tmp_path / "ckpt"), *extra]


def test_run_ppo_smoke_and_resume(tmp_path):
    """``main --smoke`` on the CPU: finite losses, the params move, a
    checkpoint per iteration, and ``--resume`` continues after the last."""
    pol = ttrain.main(smoke_args(tmp_path, "--iterations", "2"))
    cfg, _ = ttrain.parse_config(smoke_args(tmp_path))
    init = ttrain.build_agent(cfg).init_fn(
        torch.Generator().manual_seed(cfg.seed))
    assert any(not torch.equal(a, b) for a, b in
               zip(pol.state_dict().values(), init.state_dict().values()))
    lines = [json.loads(l) for l in open(tmp_path / "log.jsonl")]
    its = [l for l in lines if "iteration" in l]
    assert [l["iteration"] for l in its] == [0, 1]
    for l in its:
        assert np.isfinite(l["total_loss"]) and l["rollout_ms"] > 0
    ck = Checkpointer(str(tmp_path / "ckpt"))
    assert ck.steps() == [0, 1]
    saved = ck.restore()
    assert saved["iteration"] == 1
    assert all(torch.equal(v, pol.state_dict()[k])
               for k, v in saved["params"].items())

    pol3 = ttrain.main(smoke_args(tmp_path, "--iterations", "3",
                                  "--resume"))
    lines = [json.loads(l) for l in open(tmp_path / "log.jsonl")]
    assert [l["iteration"] for l in lines if "iteration" in l] == [0, 1, 2]
    assert ck.steps() == [0, 1, 2]
    assert any(not torch.equal(a, b) for a, b in
               zip(pol3.state_dict().values(), pol.state_dict().values()))


def test_checkpointer_keeps_five(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.restore() is None
    for i in range(7):
        ck.save(i, {"iteration": i, "x": torch.full((2,), float(i))})
    assert ck.steps() == [2, 3, 4, 5, 6]
    assert float(ck.restore(4)["x"][0]) == 4.0


def test_bf16_mlp_smoke(tmp_path):
    """``--dtype bfloat16`` runs the MLP torso in bf16 through the trainer:
    the policy carries the dtype, keeps float32 parameters, and the loss is
    finite."""
    pol = ttrain.main(smoke_args(tmp_path, "--iterations", "1", "--dtype",
                                 "bfloat16"))
    assert pol.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pol.parameters())
    its = [json.loads(l) for l in open(tmp_path / "log.jsonl")]
    assert np.isfinite([l for l in its if "iteration" in l][0]["total_loss"])
    cfg, _ = ttrain.parse_config(smoke_args(tmp_path))
    assert ttrain.build_agent(cfg).init_fn().dtype == torch.float32


def test_profile_trace_writes_a_trace(tmp_path):
    """``profile_trace`` yields the profiler and leaves a Chrome trace with
    the traced ops under ``logdir``, and the program's spans on a track of
    their own, each over the operators run inside it."""
    from arcle_tpu_torch.ops import o2arc_table
    from arcle_tpu_torch.utils import profile_trace
    env = BatchedEnv(table=o2arc_table(127),
                     bank=SyntheticLoader(4, seed=3).bank(device="cpu"),
                     max_trial=127, episode_limit=3, reset_pool=2)
    gen = torch.Generator().manual_seed(0)
    bs = env.reset(gen, 4)
    act = random_bbox_actions(gen, 4, env.table.n_ops, 30, 30, "cpu")
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
        env.step(bs, act)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e["name"] for e in events if "name" in e}
    assert any("mm" in n for n in names)
    assert any("mm" in e.key for e in prof.key_averages())
    spans = [e for e in events if e.get("cat") == "span"]
    step = [e for e in spans if e["name"] == "env.step"]
    assert len(step) == 1 and step[0]["ph"] == "X"
    assert {e["name"] for e in spans} >= {"step_kernel", "auto_reset"}
    assert {e["pid"] for e in spans}.isdisjoint(
        {e["pid"] for e in events
         if e.get("ph") == "X" and e.get("cat") != "span"})
    a, b = step[0]["ts"], step[0]["ts"] + step[0]["dur"]
    inside = [e for e in events if e.get("name") == "aten::where"]
    assert inside and all(a - 20 <= e["ts"] and e["ts"] + e["dur"] <= b + 20
                          for e in inside)


def test_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = smoke_args(tmp_path)
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(args)


def test_train_imports_no_jax():
    """Importing the training entry points, E-MAML, the GPT and the
    answer-given suite in a fresh interpreter leaves jax, flax, optax and
    arcle_tpu out of sys.modules."""
    code = (
        "import sys\n"
        "import arcle_tpu_torch.training.train\n"
        "import arcle_tpu_torch.training.train_gpt\n"
        "import arcle_tpu_torch.training.emaml\n"
        "import arcle_tpu_torch.training.supervise\n"
        "import arcle_tpu_torch.models.gpt\n"
        "import arcle_tpu_torch.benchmarks\n"
        "import arcle_tpu_torch.benchmarks.eval_answer_given\n"
        "import arcle_tpu_torch.training.train_answer_given\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'arcle_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
