"""The port's E-MAML step against ``arcle_tpu``'s.

Both packages run one meta-iteration of the MLP policy (hidden=(16,))
from the same weights (carried with ``fcpolicy_state_dict_from_flax``),
on the same trajectories: ``task_rollout`` is replaced in both packages by
a function that hands out fixed numpy-made trajectories, one per rollout
of the step (inner steps, then the post-adaptation rollout), so the test
holds the learner alone.  The behaviour log-probs are the policy's own
plus noise, so the importance ratios and KLs move.

Compared after the step: the meta loss and every metric of
``_finish_step`` (rtol 1e-4 / atol 1e-6: the last meta-opt step's losses
are taken after an AdamW step, whose float32 differences of ~1e-8 the
value loss amplifies to ~1e-5 relative; integers exact), the params
after the AdamW meta steps (atol 1e-5), the AdamW moments (rtol 1e-4,
atol 1e-4 of their largest entry), the KL-ladder coefficients and the
task bookkeeping (exact), for the fused step (first and second
order, one and two micro-batches) and the chunked FOMAML step
(``cache_chain`` and ``kl_ladder_grads`` each both ways, one and two
micro-batches).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.envs import BatchedEnv as JBatchedEnv
from arcle_tpu.envs.core import ResetOptions as JResetOptions
from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
from arcle_tpu.models.mlp import FCPolicy as JFCPolicy
from arcle_tpu.ops import o2arc_table as j_o2arc
from arcle_tpu.training.rollout import Trajectory as JTrajectory
from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.models import (
    FCPolicy, adam_state_from_optax, fcpolicy_state_dict_from_flax,
)
from arcle_tpu_torch.ops import o2arc_table

jagents, jemaml, jppo = (importlib.import_module(f"arcle_tpu.training.{m}")
                         for m in ("agents", "emaml", "ppo"))
tagents, temaml, tppo, troll = (
    importlib.import_module(f"arcle_tpu_torch.training.{m}")
    for m in ("agents", "emaml", "ppo", "rollout"))

N_TASKS, E, S, N_BANK = 2, 2, 4, 6
HIDDEN = (16,)
FLOAT_METRICS = (
    "meta_loss", "outer_policy_loss", "outer_vf_loss", "outer_kl_loss",
    "outer_total_loss", "adapt_reward_mean", "adapt_reward_max",
    "adapt_reward_min", "post_reward_mean", "post_reward_per_task",
    "post_eprew_mean", "post_eprew_max", "post_eprew_min", "inner_kl_mean")
INT_METRICS = ("sampled_tasks", "once_successful", "num_covered_tasks",
               "num_succeed_tasks")


def flax_to_state(params):
    return fcpolicy_state_dict_from_flax(jax.tree.map(np.asarray, params))


def make_trajectories(rng, params, jagent, n_rollouts):
    """``n_rollouts`` fixed trajectories in the port's layout
    ``[S, N_TASKS * E, ...]`` with last values ``[N_TASKS * E]``; the
    behaviour log-probs are the policy's at ``params`` plus N(0, 0.05)
    noise; task 0 earns a positive reward in every rollout (a solve)."""
    B = N_TASKS * E
    out = []
    for _ in range(n_rollouts):
        # 0/1 cells keep the tanh units off saturation: a saturated unit's
        # ~1e-9 gradients make AdamW's first step (~lr * sign(g)) a coin
        # toss between any two summation orders
        obs = rng.integers(0, 2, (S, B, 2710)).astype(np.int8)
        acts = np.concatenate([rng.integers(0, 30, (S, B, 4)),
                               rng.integers(0, 35, (S, B, 1))],
                              -1).astype(np.int32)
        lp, _, _ = jagent.evaluate_fn(params, jnp.asarray(obs.reshape(S * B,
                                                                      -1)),
                                      jnp.asarray(acts.reshape(S * B, 5)))
        lp = np.asarray(lp).reshape(S, B) + rng.normal(0, 0.05, (S, B))
        term = rng.random((S, B)) < 0.15
        dones = term | (rng.random((S, B)) < 0.15)
        rewards = rng.normal(-0.5, 1.0, (S, B))
        rewards[:, :E] = np.abs(rewards[:, :E])
        rewards[:, E:] = -np.abs(rewards[:, E:])
        out.append(dict(
            traj=dict(obs=obs, actions=acts, log_probs=lp.astype(np.float32),
                      values=rng.normal(0, 0.3, (S, B)).astype(np.float32),
                      rewards=rewards.astype(np.float32), dones=dones,
                      terminated=term,
                      final_values=np.where(dones & ~term,
                                            rng.normal(0, 0.3, (S, B)),
                                            0).astype(np.float32)),
            last_v=rng.normal(0, 0.3, B).astype(np.float32)))
    return out


def task_major(x):
    """``[S, N_TASKS * E, ...]`` -> JAX's ``[N_TASKS, S, E, ...]``."""
    x = np.asarray(x)
    return np.swapaxes(x.reshape((S, N_TASKS, E) + x.shape[2:]), 0, 1)


def run_jax(cfg, params, trajs, assign):
    """One JAX meta-iteration, its task_rollout handing out ``trajs`` in
    order (the carry's step counter picks the rollout, as the fused step
    traces its inner loop once)."""
    stacked = {k: jnp.asarray(np.stack([task_major(t["traj"][k])
                                        for t in trajs]))
               for k in trajs[0]["traj"]}
    last = jnp.asarray(np.stack([t["last_v"].reshape(N_TASKS, E)
                                 for t in trajs]))

    def fake_rollout(env, bs, task_params, key, agent, cfg_, deterministic):
        idx = bs.env.steps[0]
        traj = jax.tree.map(lambda a: a[idx], JTrajectory(**stacked))
        bs = dataclasses.replace(bs, env=bs.env.replace(
            steps=bs.env.steps + 1))
        return bs, traj, last[idx]

    ag = jagents.mlp_agent(JFCPolicy(hidden=HIDDEN, n_ops=35))
    opts = JResetOptions(prob_index=jnp.asarray(assign),
                         subprob_index=jnp.full_like(assign, -1),
                         adaptation=jnp.ones((), bool),
                         reset_on_submit=jnp.zeros((), bool))
    env = JBatchedEnv(table=j_o2arc(7, crop_at_33=True),
                      bank=JSyntheticLoader(N_BANK, seed=2).bank(),
                      max_trial=7, episode_limit=8, auto_reset=True,
                      opts=opts)
    bs = env.reset(jax.random.key(2), N_TASKS * E)
    st = jemaml.init_emaml(ag, cfg, jax.random.key(0), n_bank_tasks=N_BANK)
    st = st._replace(params=params, opt_state=jemaml.make_meta_optimizer(
        cfg).init(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jemaml, "task_rollout", fake_rollout)
        if cfg.chunked:
            st2, _, m = jemaml.make_chunked_train_step(ag, cfg)(st, env, bs)
        else:
            st2, _, m = jax.jit(jemaml.emaml_train_step,
                                static_argnums=(3, 4))(st, env, bs, ag, cfg)
    return st2, m


def run_port(cfg, params, trajs, assign):
    """The same meta-iteration in the port, on the CPU."""
    ag = tagents.mlp_agent(FCPolicy(hidden=HIDDEN, n_ops=35))
    calls = []

    def fake_rollout(env, bs, task_params, gen, agent, cfg_, deterministic):
        i = len(calls)
        calls.append(deterministic)
        t = trajs[i]
        traj = troll.Trajectory(**{k: torch.tensor(v)
                                   for k, v in t["traj"].items()})
        return bs, traj, torch.tensor(t["last_v"])

    opts = ResetOptions.make(prob_index=torch.tensor(assign), device="cpu")
    env = BatchedEnv(table=o2arc_table(7, crop_at_33=True),
                     bank=SyntheticLoader(N_BANK, seed=2).bank(device="cpu"),
                     max_trial=7, episode_limit=8, auto_reset=True,
                     opts=opts)
    bs = env.reset(torch.Generator().manual_seed(0), N_TASKS * E)
    st = temaml.init_emaml(ag, cfg, 0, n_bank_tasks=N_BANK, device="cpu")
    st.params.load_state_dict(flax_to_state(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(temaml, "task_rollout", fake_rollout)
        if cfg.chunked:
            st, _, m = temaml.make_chunked_train_step(ag, cfg)(st, env, bs)
        else:
            st, _, m = temaml.emaml_train_step(st, env, bs, ag, cfg)
    assert calls == [False] * cfg.inner_steps + [True]
    return st, m


CASES = {
    "fused_first_order": dict(first_order=True),
    "fused_first_order_micro2": dict(first_order=True, n_micro=2),
    "fused_second_order": dict(first_order=False),
    "chunked_exact_ladder": dict(chunked=True, cache_chain=False,
                                 kl_ladder_grads=True),
    "chunked_cached_ladder_micro2": dict(chunked=True, cache_chain=True,
                                         kl_ladder_grads=True, n_micro=2),
    "chunked_exact_fastkl_micro2": dict(chunked=True, cache_chain=False,
                                        kl_ladder_grads=False, n_micro=2),
    "chunked_cached_fastkl": dict(chunked=True, cache_chain=True,
                                  kl_ladder_grads=False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_emaml_step_matches(case):
    kw = dict(n_tasks=N_TASKS, envs_per_task=E, rollout_steps=S,
              inner_steps=2, maml_opt_steps=2, inner_lr=0.05, meta_lr=1e-3,
              first_order=True)
    kw.update(CASES[case])
    jcfg = jemaml.EMAMLConfig(**kw, ppo=jppo.PPOConfig())
    tcfg = temaml.EMAMLConfig(**kw, ppo=tppo.PPOConfig())
    jag = jagents.mlp_agent(JFCPolicy(hidden=HIDDEN, n_ops=35))
    params = jag.init_fn(jax.random.key(1), jnp.zeros((1, 2710), jnp.int8))
    trajs = make_trajectories(np.random.default_rng(0), params, jag,
                              kw["inner_steps"] + 1)
    assign = np.repeat(np.array([4, 1], np.int32), E)

    jst, jm = run_jax(jcfg, params, trajs, assign)
    tst, tm = run_port(tcfg, params, trajs, assign)

    for k in FLOAT_METRICS:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k in INT_METRICS:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]), k)
    assert set(tm) >= set(jm) - {"post_batch"}
    for f in jm["post_batch"]._fields:
        j, t = getattr(jm["post_batch"], f), getattr(tm["post_batch"], f)
        assert (j is None) == (t is None), f
        if j is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-6, err_msg=f"post_batch {f}")
    assert bool(tm["once_successful"][0]) and not bool(
        tm["once_successful"][1])
    np.testing.assert_array_equal(tst.kl_coeffs.numpy(),
                                  np.asarray(jst.kl_coeffs))
    assert not np.all(np.asarray(jst.kl_coeffs) == 0.0005)   # the ladder moved
    np.testing.assert_array_equal(tst.tasks_covered.numpy(),
                                  np.asarray(jst.tasks_covered))
    np.testing.assert_array_equal(tst.tasks_succeeded.numpy(),
                                  np.asarray(jst.tasks_succeeded))
    moved = 0.0
    for name, v in flax_to_state(jst.params).items():
        np.testing.assert_allclose(tst.params.state_dict()[name].numpy(),
                                   v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"param {name}")
        moved = max(moved, float((v - flax_to_state(params)[name]).abs()
                                 .max()))
    assert moved > 1e-3                      # two AdamW steps of lr 1e-3
    # the AdamW moments, carried back the other way, match the port's
    ref = adam_state_from_optax(jst.opt_state, tst.params)
    for p in tst.params.parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            want = ref[p][key]
            torch.testing.assert_close(tst.opt.state[p][key], want,
                                       rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))
        assert float(tst.opt.state[p]["step"]) == float(ref[p]["step"]) == 2


def test_chunked_requires_first_order():
    ag = tagents.mlp_agent(FCPolicy(hidden=(8,), n_ops=35))
    with pytest.raises(ValueError, match="first_order"):
        temaml.make_chunked_train_step(ag, temaml.EMAMLConfig(
            first_order=False))


def test_microbatches_refuse_a_non_divisor():
    """The per-task batch must split into n_micro equal micro-batches, as
    in the JAX package (train_gpt's default n_micro can miss; ROADMAP
    queue 3)."""
    b = tppo.PPOBatch(*(torch.zeros(6) for _ in range(6)))
    assert len(temaml._microbatches(b, 3)) == 3
    with pytest.raises(ValueError, match="not divisible by n_micro=4"):
        temaml._microbatches(b, 4)


def test_sample_task_assignment():
    """Tasks drawn without replacement, each repeated over its envs."""
    cfg = temaml.EMAMLConfig(n_tasks=4, envs_per_task=3)
    a = temaml.sample_task_assignment(torch.Generator().manual_seed(0), 5,
                                      cfg)
    assert a.dtype == torch.int32 and a.shape == (12,)
    tasks = a.view(4, 3)
    assert bool((tasks == tasks[:, :1]).all())
    assert len(set(tasks[:, 0].tolist())) == 4 and int(a.max()) < 5
    with pytest.raises(ValueError):
        temaml.sample_task_assignment(torch.Generator(), 3, cfg)


def test_task_rollout_steps_all_tasks_together():
    """``task_rollout`` runs each task's params on its own slice of envs
    and steps the whole batch once per rollout step: the port's
    ``BatchedEnv.step`` is called ``rollout_steps`` times, on all
    ``n_tasks * envs_per_task`` envs, and each task's actions come from
    its own params."""
    cfg = temaml.EMAMLConfig(n_tasks=2, envs_per_task=3, rollout_steps=4)
    pol = FCPolicy(hidden=(8,), n_ops=35,
                   generator=torch.Generator().manual_seed(0))
    ag = tagents.mlp_agent(pol)
    env = BatchedEnv(table=o2arc_table(7), bank=SyntheticLoader(
        4, seed=1).bank(device="cpu"), max_trial=7, episode_limit=3,
        opts=ResetOptions.make(prob_index=torch.tensor([0, 0, 0, 2, 2, 2]),
                               device="cpu"), reset_pool=2)
    bs = env.reset(torch.Generator().manual_seed(1), 6)
    p0 = dict(pol.named_parameters())
    # task 1's params push its op logits to one op
    p1 = {k: v.detach().clone() for k, v in p0.items()}
    with torch.no_grad():
        p1["pi.bias"][120 + 7] = 1e4
    batches = []
    real_step = BatchedEnv.step

    def counting_step(self, bs_, act):
        batches.append(act.operation.shape[0])
        return real_step(self, bs_, act)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BatchedEnv, "step", counting_step)
        _, traj, last_v = temaml.task_rollout(
            env, bs, [p0, p1], torch.Generator().manual_seed(2), ag, cfg,
            False)
    assert batches == [6] * 4
    assert traj.actions.shape == (4, 6, 5) and last_v.shape == (6,)
    assert bool((traj.actions[:, 3:, 4] == 7).all())
    assert not bool((traj.actions[:, :3, 4] == 7).all())
