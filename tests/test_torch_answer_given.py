"""The port's answer-given suite (paper §4.1) against ``arcle_tpu``'s.

The same inputs, made from a seed with numpy, go through both packages:
the task banks and the colour-only op table, the 5x5 env (through the XLA
step on the JAX side, the plain PyTorch step here) with pinned tasks
across auto-resets, the observation, the three policy architectures with
both selection heads, one PPO iteration with potential shaping, and the
entry points.  Weights cross over through ``arcle_tpu_torch.models.convert``.

Integer results are bit-exact.  Float results carry the tolerance stated
at each test; the policies run in float32 here (their default is bf16,
which ``tests/test_torch_gpt.py`` holds at its own tolerance).
"""

import argparse
import dataclasses
import functools
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.benchmarks import answer_given as jag
from arcle_tpu.core.state import Action as JAction
from arcle_tpu.envs import BatchedEnv as JBatchedEnv
from arcle_tpu.envs import ResetOptions as JResetOptions
from arcle_tpu.models.gpt import GPTPolicy as JGPTPolicy
from arcle_tpu.ops.table import pixel_reward as j_pixel_reward

from arcle_tpu_torch.benchmarks import answer_given as tag
from arcle_tpu_torch.benchmarks import eval_answer_given as teval
from arcle_tpu_torch.core import Action, FIELDS
from arcle_tpu_torch.envs import ResetOptions
from arcle_tpu_torch.models import GPTPolicy, gpt_state_dict_from_flax
from arcle_tpu_torch.ops.table import pixel_reward
from arcle_tpu_torch.utils import Checkpointer

jppo, jroll = (importlib.import_module(f"arcle_tpu.training.{m}")
               for m in ("ppo", "rollout"))
tppo, troll, ttrain = (importlib.import_module(f"arcle_tpu_torch.training.{m}")
                       for m in ("ppo", "rollout", "train_answer_given"))

BANK_FIELDS = ("in_grids", "in_dims", "out_grids", "out_dims",
               "train_offset", "train_count", "test_offset", "test_count")
SMALL = dict(n_layer=1, n_head=2, n_embd=32)
TINY = float(jnp.finfo(jnp.float32).tiny)


def to_torch(x):
    return torch.tensor(np.asarray(x))


def npy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_banks_equal(jbank, tbank, what=""):
    for f in BANK_FIELDS:
        j, t = np.asarray(getattr(jbank, f)), getattr(tbank, f).numpy()
        assert j.dtype == t.dtype and j.shape == t.shape, (what, f)
        np.testing.assert_array_equal(j, t, err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# Task distributions and the op table
# ---------------------------------------------------------------------------
LOADERS = {
    "random": lambda m: m.RandomPairLoader(24, 5, 5, 7, seed=3),
    "random_4x6": lambda m: m.RandomPairLoader(9, 4, 6, 10, seed=0),
    # 40 of each batch of 64 candidates keep their shapes, so the refill
    # loop (the seed moving on by 1000003) runs more than once
    "arc": lambda m: m.small_arc_loader(64, 5, 10, seed=3),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_banks_are_bit_identical(name):
    """Both loaders draw with numpy in the JAX package's order: the same
    seed gives the same tasks and the same bank, field for field."""
    jl, tl = LOADERS[name](jag), LOADERS[name](tag)
    assert len(jl.data) == len(tl.data)
    for jt, tt in zip(jl.data, tl.data):
        for ja, ta in zip(jt[:4], tt[:4]):
            assert len(ja) == len(ta)
            for x, y in zip(ja, ta):
                np.testing.assert_array_equal(x, y)
        assert jt[4] == tt[4]
    H, W = (4, 6) if name == "random_4x6" else (5, 5)
    assert_banks_equal(jl.bank(H=H, W=W), tl.bank(H=H, W=W, device="cpu"),
                       name)
    if name == "arc":
        first = list(tag.make_tasks(64, seed=3, min_size=2, max_size=5,
                                    n_train=2, n_test=1, colors=10))
        kept = [t for t in first if all(
            i.shape == o.shape for i, o in zip(t[0] + t[2], t[1] + t[3]))]
        assert len(kept) < 64           # the refill loop ran


@pytest.mark.parametrize("n", [10, 4])
def test_color_table_matches(n):
    jt, tt = jag.color_table(n), tag.color_table(n)
    for f in ("name", "group", "param", "reset_sel", "max_trial",
              "submit_op"):
        assert getattr(jt, f) == getattr(tt, f), f
    assert tt.n_ops == n and tt.submit_op == -1
    assert tuple(tt.rows("cpu").shape) == (3, n)


def test_continual_banks_share_shapes():
    """§4.1.3: the five phase banks (2/4/6/8/10 colours, seeds 100 + c) have
    one shape and dtype per field, stay inside their palette, and equal
    the JAX package's."""
    cs = ttrain.CONTINUAL_COLORS
    assert cs == (2, 4, 6, 8, 10)
    banks = [tag.RandomPairLoader(16, 5, 5, c, 100 + c).bank(
        H=5, W=5, device="cpu") for c in cs]
    ref = [(getattr(banks[0], f).shape, getattr(banks[0], f).dtype)
           for f in BANK_FIELDS]
    for b, c in zip(banks, cs):
        assert [(getattr(b, f).shape, getattr(b, f).dtype)
                for f in BANK_FIELDS] == ref
        assert int(b.in_grids.max()) < c and int(b.out_grids.max()) < c
        assert_banks_equal(jag.RandomPairLoader(16, 5, 5, c, 100 + c).bank(
            H=5, W=5), b, f"colors={c}")


# ---------------------------------------------------------------------------
# The env
# ---------------------------------------------------------------------------
B_ENV, STEPS_ENV = 48, 64
_jstep = jax.jit(JBatchedEnv.step)


def pinned_envs(setting, rng, episode_limit):
    """The answer-given env of both packages with per-env pinned tasks,
    so the pool-less auto-reset (a fresh draw on every step) is the same
    in both."""
    kw = dict(n_tasks=32, h=5, w=5, colors=10, seed=5,
              episode_limit=episode_limit, setting=setting)
    jenv = jag.answer_given_env(**kw)
    tenv = tag.answer_given_env(**kw, device="cpu")
    rows = dict(prob_index=rng.integers(0, 32, B_ENV).astype(np.int32),
                subprob_index=(rng.integers(0, 2, B_ENV) if setting == "arc"
                               else np.zeros(B_ENV)).astype(np.int32),
                adaptation=np.ones(B_ENV, bool),
                reset_on_submit=np.zeros(B_ENV, bool))
    jenv = dataclasses.replace(jenv, opts=JResetOptions(
        **{k: jnp.asarray(v) for k, v in rows.items()}))
    tenv = dataclasses.replace(tenv, opts=ResetOptions.make(**rows,
                                                            device="cpu"))
    return jenv, tenv


def env_actions(rng, st, helpful):
    """A bbox action per env: for the ``helpful`` envs (most steps) one
    wrong cell inside the answer painted in the answer's colour, so their
    episodes end solved; any box and colour otherwise."""
    grid, ans = st.grid.numpy(), st.answer.numpy()
    ad = st.answer_dim.numpy()
    sel = np.zeros((B_ENV, 5, 5), np.int8)
    ops = rng.integers(0, 10, B_ENV).astype(np.int32)
    for b in range(B_ENV):
        wrong = np.argwhere((grid[b] != ans[b])[:ad[b, 0], :ad[b, 1]])
        if helpful[b] and len(wrong) and rng.random() < 0.9:
            r, c = wrong[rng.integers(len(wrong))]
            sel[b, r, c] = 1
            ops[b] = ans[b, r, c]
        else:
            x1, x2 = sorted(rng.integers(0, 5, 2))
            y1, y2 = sorted(rng.integers(0, 5, 2))
            sel[b, x1:x2 + 1, y1:y2 + 1] = 1
    return sel, ops


@pytest.mark.parametrize("setting", ["random", "arc"])
def test_answer_given_env_matches(setting):
    """64 steps of 48 envs with ``episode_limit=30``: obs and carry
    bit-exact per field, term and trunc bit-exact, the pixel reward rtol
    1e-6 (one float32 division, which XLA may fuse otherwise); solved
    terminations, truncations and auto-resets all occur, and in the ARC
    setting dims below 5."""
    rng = np.random.default_rng(11)
    jenv, tenv = pinned_envs(setting, rng, 30)
    jbs = jenv.reset(jax.random.key(0), B_ENV)
    tbs = tenv.reset(torch.Generator().manual_seed(0), B_ENV)
    helpful = np.arange(B_ENV) % 2 == 0
    n_term = n_trunc = 0
    small = False
    for t in range(STEPS_ENV):
        for name in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jbs.env, name)),
                getattr(tbs.env, name).numpy(), f"step {t} carry {name}")
        small |= bool((tbs.env.answer_dim.prod(-1) < 25).any())
        sel, ops = env_actions(rng, tbs.env, helpful)
        jbs, jobs, jr, jterm, jtrunc = _jstep(
            jenv, jbs, JAction(selection=jnp.asarray(sel),
                               operation=jnp.asarray(ops)))
        tbs, tobs, tr, tterm, ttrunc = tenv.step(
            tbs, Action(selection=torch.from_numpy(sel),
                        operation=torch.from_numpy(ops)))
        for name in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(jobs, name)), getattr(tobs, name).numpy(),
                f"step {t} obs {name}")
        np.testing.assert_array_equal(np.asarray(jterm), tterm.numpy())
        np.testing.assert_array_equal(np.asarray(jtrunc), ttrunc.numpy())
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
        assert float(tr.max()) <= 0.0 and float(tr.min()) >= -1.0
        # a solve gives reward 0 and terminates
        np.testing.assert_array_equal((tr == 0).numpy(), tterm.numpy())
        n_term += int(tterm.sum())
        n_trunc += int((ttrunc & ~tterm).sum())
    assert n_term >= B_ENV // 2 and n_trunc >= B_ENV // 2
    assert small == (setting == "arc")


def scribbled_state(seed=7, n=32):
    """ARC-setting states (dims below 5 among them) with every grid cell
    redrawn, cells outside ``answer_dim`` included."""
    tenv = tag.answer_given_env(n_tasks=32, setting="arc", seed=seed,
                                episode_limit=8, device="cpu")
    st = tenv.reset(torch.Generator().manual_seed(1), n).env
    rng = np.random.default_rng(0)
    st = st.replace(grid=torch.from_numpy(
        rng.integers(0, 10, (n, 5, 5)).astype(np.int8)))
    assert bool((st.answer_dim.prod(-1) < 25).any())
    return st


def test_answer_obs_and_potential_match():
    """``answer_obs`` is int8 here and float32 in the JAX package, with
    the same values; ``_unpack`` gives the state's fields back; and
    ``shaping_potential`` equals both packages' ``pixel_reward`` of the
    same state and JAX's potential (atol 1e-6), on int8 and on float32
    observations, with leading ``[T, B]`` axes too."""
    st = scribbled_state()
    jst = jag.EnvState(**{f: jnp.asarray(getattr(st, f).numpy())
                          for f in FIELDS})
    tobs, jobs = tag.answer_obs(st), jag.answer_obs(jst)
    assert tobs.dtype == torch.int8 and tobs.shape == (32, 54)
    assert jobs.dtype == jnp.float32
    np.testing.assert_array_equal(tobs.numpy().astype(np.float32),
                                  np.asarray(jobs))
    for got, name in zip(tag._unpack(tobs, 5, 5),
                         ("grid", "grid_dim", "answer", "answer_dim")):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), getattr(st, name).numpy())
    for j, t in zip(jag._unpack(jobs, 5, 5), tag._unpack(tobs.float(), 5, 5)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    ref = pixel_reward(st, 5).numpy()
    np.testing.assert_allclose(
        ref, np.asarray(jax.vmap(j_pixel_reward)(jst)), atol=1e-6)
    jphi = np.asarray(jag.shaping_potential(jobs, 5, 5))
    for obs in (tobs, tobs.float(), tobs.reshape(4, 8, 54)):
        phi = tag.shaping_potential(obs, 5, 5)
        assert phi.dtype == torch.float32
        np.testing.assert_allclose(phi.numpy().reshape(-1), ref, atol=1e-6)
        np.testing.assert_allclose(phi.numpy().reshape(-1), jphi, atol=1e-6)


# ---------------------------------------------------------------------------
# The agent: three architectures x two selection heads
# ---------------------------------------------------------------------------
ARCHS = {"color_eq": dict(color_equivariant=True),
         "nonseq": dict(color_equivariant=False, factorized=True),
         "sequential": dict(color_equivariant=False)}


def f32_policies(arch, head, colors=10, seed=0, size=5):
    """The §4.1.2 policy of both packages in float32, the flax weights
    carried into the port's.  The last kernel of the op and selection
    heads is scaled up, so argmax actions have margins far above the
    float32 difference of the two packages."""
    kw = dict(h=size, w=size, colors=colors, bbox_dist_kind=head, **SMALL,
              **ARCHS[arch])
    jm = jag.make_policy(**kw)
    jm = JGPTPolicy(dataclasses.replace(jm.cfg, dtype=jnp.float32))
    tm = tag.make_policy(**kw)
    assert tm.cfg.dtype == torch.bfloat16 and not tm.cfg.remat
    assert tm.cfg.bbox_bins == (size if head == "categorical" else 0)
    tm = GPTPolicy(dataclasses.replace(tm.cfg, dtype=torch.float32))
    jagent = jag.answer_given_agent(jm, sequential=(arch == "sequential"))
    tagent = tag.answer_given_agent(tm, sequential=(arch == "sequential"))
    params = jagent.init_fn(jax.random.key(seed),
                            jnp.zeros((1, 2 * size * size + 4), jnp.float32))
    params = jax.tree.map(lambda x: x, params)       # a mutable copy
    sfx = "_f" if arch == "nonseq" else ""
    for name in ("operation", "bbox_mean", "bbox_logits"):
        head_p = params["params"].get(f"head_{name}{sfx}")
        if head_p is not None:
            head_p["Dense_2"]["kernel"] = head_p["Dense_2"]["kernel"] * 30.0
    tm.load_state_dict(gpt_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    return jagent, params, tagent, tm


@functools.lru_cache(maxsize=None)
def agent_case(arch, head):
    return f32_policies(arch, head)


def random_obs_actions(rng, n, colors=10):
    """Answer-given observations with dims in [2, 5] and grids zero
    outside them, and stored actions."""
    dims = rng.integers(2, 6, (n, 2))
    inside = (np.arange(5)[None, :, None] < dims[:, :1, None]) & \
        (np.arange(5)[None, None, :] < dims[:, 1:, None])
    cells = lambda: np.where(inside, rng.integers(0, colors, (n, 5, 5)),
                             0).reshape(n, 25)
    obs = np.concatenate([cells(), dims, cells(), dims], 1).astype(np.int8)
    acts = np.concatenate([rng.integers(0, 5, (n, 4)),
                           rng.integers(0, colors, (n, 1))],
                          1).astype(np.int32)
    return obs, acts


def close(actual, desired, what, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(npy(actual), np.asarray(desired), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("head", ["categorical", "truncnorm"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_agent_matches(arch, head):
    """``evaluate_fn`` (log-prob, value, entropy) and ``aux_fn`` on the
    same observations and stored actions, the port's params as the module
    and as a name -> tensor dict: atol 1e-5 (float32).  ``sample_fn``
    deterministic, and sampling with JAX's uniforms injected: actions
    bit-exact, log-prob and value atol 1e-5.  The sampled log-prob equals
    ``evaluate_fn``'s of the drawn action (PPO ratios start at 1), also
    through the sequential architecture's second forward."""
    jagent, params, tagent, tm = agent_case(arch, head)
    rng = np.random.default_rng(4)
    n = 16
    obs, acts = random_obs_actions(rng, n)
    jobs, jacts = jnp.asarray(obs, jnp.float32), jnp.asarray(acts)
    tobs, tacts = torch.from_numpy(obs), torch.from_numpy(acts)
    jev = jax.jit(jagent.evaluate_fn)(params, jobs, jacts)
    jaux = jax.jit(jagent.aux_fn)(params, jobs, jacts)
    with torch.no_grad():
        for p in (tm, dict(tm.named_parameters())):
            tev = tagent.evaluate_fn(p, tobs, tacts)
            for name, t, j in zip(("log_prob", "value", "entropy"), tev,
                                  jev):
                close(t, j, f"{arch} {head} {name}")
            taux = tagent.aux_fn(p, tobs, tacts)
            assert set(taux) == set(jaux)
            for k in jaux:
                close(taux[k], jaux[k], f"{arch} {head} aux {k}")

    key = jax.random.key(9)
    k_op, k_bb = jax.random.split(key)
    u_op = to_torch(jax.random.uniform(k_op, (n, 10), minval=TINY,
                                       maxval=1.0))
    if head == "categorical":
        u_bb = to_torch(jax.random.uniform(k_bb, (n, 4, 5), minval=TINY,
                                           maxval=1.0))
    else:
        u_bb = to_torch(jax.random.uniform(k_bb, (n, 4), minval=1e-6,
                                           maxval=1.0 - 1e-6))
    jsample = jax.jit(jagent.sample_fn, static_argnums=(3,))
    for det in (True, False):
        ja, jlp, jv = jsample(params, jobs, key, det)
        with torch.no_grad():
            ta, tlp, tv = tagent.sample_fn(tm, tobs, None, det,
                                           u=(u_op, u_bb))
            lp2, v2, _ = tagent.evaluate_fn(tm, tobs, ta)
        assert ta.dtype == torch.int32 and ta.shape == (n, 5)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja),
                                      f"{arch} {head} det={det} actions")
        close(tlp, jlp, f"{arch} {head} det={det} log_prob")
        close(tv, jv, f"{arch} {head} det={det} value")
        close(lp2, tlp, "the drawn action's log-prob", atol=1e-5)
        close(v2, tv, "value", atol=1e-6)
    # a draw from a generator lands on the grid and on an op
    ta, _, _ = tagent.sample_fn(tm, tobs, torch.Generator().manual_seed(0))
    assert bool(((ta >= 0) & (ta[:, :4] < 5).all(1, keepdim=True)).all())
    assert bool((ta[:, 4] < 10).all())


def test_sequential_selection_depends_on_the_op():
    """The sequential policy's selection reads a forward conditioned on
    the op: another op changes the bbox log-prob by more than the op's own
    term, where the one-pass policy's bbox term moves only with the op's
    head row."""
    _, _, tagent, tm = agent_case("sequential", "categorical")
    obs, acts = random_obs_actions(np.random.default_rng(5), 8)
    acts2 = acts.copy()
    acts2[:, 4] = (acts2[:, 4] + 1) % 10
    with torch.no_grad():
        lp1, v1, _ = tagent.evaluate_fn(tm, torch.from_numpy(obs),
                                        torch.from_numpy(acts))
        lp2, v2, _ = tagent.evaluate_fn(tm, torch.from_numpy(obs),
                                        torch.from_numpy(acts2))
    assert not np.allclose(lp1.numpy(), lp2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())


# ---------------------------------------------------------------------------
# One PPO iteration on JAX's trajectory
# ---------------------------------------------------------------------------
B_IT, T_IT, SIZE_IT = 16, 12, 2


def iteration_args(**kw):
    base = dict(setting="random", size=SIZE_IT, colors=2, n_tasks=8,
                episode_limit=8, arch="color_eq", aux="all", aux_coeff=0.3,
                n_layer=1, n_head=2, n_embd=32, n_envs=B_IT, rollout=T_IT,
                lr=3e-4, gamma=0.95, gae_lambda=0.95, clip=0.2,
                vf_coeff=0.5, ent_coeff=0.01, epochs=1, minibatches=1,
                seed=0, bbox_dist="categorical", min_log_std=-2.3,
                potential_shaping=True, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@functools.lru_cache(maxsize=None)
def jax_rollout():
    """A sampled rollout of the JAX package's answer-given env with its
    float32 policy, on 2x2 grids of 2 colours, where a fresh policy solves
    some episodes and runs others into the limit."""
    from arcle_tpu.training.train_answer_given import build as jbuild
    jenv, _, _ = jbuild(iteration_args())
    jagent, params, tagent, tm = f32_policies("color_eq", "categorical",
                                              colors=2, seed=1,
                                              size=SIZE_IT)
    jbs = jenv.reset(jax.random.key(3), B_IT)
    _, jtraj, jlast = jax.jit(jroll.rollout, static_argnums=(4, 5))(
        jenv, jbs, params, jax.random.key(4), T_IT, jagent)
    return jagent, params, tagent, tm, jtraj, jlast


def jax_learner_batch(traj, last_v, pcfg, size):
    """Lines 193-223 of the JAX trainer's ``iteration`` (a closure of its
    ``main``): potential shaping, the batch, the raw rewards restored for
    the aux targets."""
    include_aux = pcfg.aux_coeff > 0.0
    phi_t = jag.shaping_potential(traj.obs, size, size)
    term_f = traj.terminated.astype(jnp.float32)
    shaped = traj.rewards * (1.0 + pcfg.gamma * (1.0 - term_f)) - phi_t
    batch = jppo.batch_from_trajectory(
        traj._replace(rewards=shaped), last_v, pcfg,
        include_aux=include_aux, grid_slice=slice(0, size * size))
    if include_aux:
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        raw_prev = jnp.concatenate(
            [jnp.zeros_like(traj.rewards[:1]),
             traj.rewards[:-1] * (1.0 - traj.dones[:-1])], axis=0)
        batch = batch._replace(rewards=flat(traj.rewards),
                               prev_rewards=flat(raw_prev))
    return batch


# A shift of every op logit changes no softmax: this bias's gradient is 0
# up to rounding, and Adam's normalisation turns that rounding into steps
# of up to lr in either package.
NULL_DIRECTIONS = ("head_operation.Dense_2.bias",)


@pytest.mark.parametrize("aux", ["none", "rtm1", "rtm1+rt", "all"])
def test_ppo_iteration_matches(aux):
    """From JAX's trajectory (obs cast to the port's int8): the learner's
    batch with potential shaping (advantages and returns rtol 1e-5 / atol
    1e-6, the aux targets the env's raw rewards), then one ``train_step``
    with an entropy coefficient off the schedule: every statistic rtol
    1e-4 (atol 1e-6 for the means that cancel to ~0), every parameter
    after the clip + Adam update atol 1e-5, the op softmax's null direction
    apart (``NULL_DIRECTIONS``)."""
    from arcle_tpu.training.train_answer_given import build as jbuild
    jagent, params, tagent, tm0, jtraj, jlast = jax_rollout()
    args = iteration_args(aux=aux)
    _, _, jcfg = jbuild(args)
    _, _, tcfg = ttrain.build(args)
    assert dataclasses.asdict(tcfg) == {
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tcfg)}
    assert bool(jtraj.terminated.any()) and \
        bool((jtraj.dones & ~jtraj.terminated).any())

    ttraj = troll.Trajectory(**{
        k: to_torch(v).to(torch.int8) if k == "obs" else to_torch(v)
        for k, v in jtraj._asdict().items()})
    jb = jax_learner_batch(jtraj, jlast, jcfg, SIZE_IT)
    tb = ttrain.learner_batch(ttraj, to_torch(jlast), tcfg, SIZE_IT, True)
    for name, j in jb._asdict().items():
        t = getattr(tb, name)
        assert (t is None) == (j is None) == (
            aux == "none" and name in ("rewards", "prev_rewards",
                                       "next_grid", "aux_valid")), name
        if t is None:
            continue
        if name in ("obs", "actions", "next_grid"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
        else:
            close(t, j, name, rtol=1e-5, atol=1e-6)
    if aux != "none":
        np.testing.assert_array_equal(tb.rewards.numpy(),
                                      np.asarray(jtraj.rewards).reshape(-1))
    # unshaped: the batch is batch_from_trajectory's
    plain = ttrain.learner_batch(ttraj, to_torch(jlast), tcfg, SIZE_IT,
                                 False)
    close(plain.returns, jppo.batch_from_trajectory(
        jtraj, jlast, jcfg).returns, "unshaped returns", 1e-5, 1e-6)

    ent = ttrain.ent_schedule(argparse.Namespace(
        ent_coeff=0.01, ent_coeff_start=0.1, ent_anneal_iters=1500), 300)
    tx = jppo.make_optimizer(jcfg)
    p2, _, jst = jax.jit(jppo.train_step, static_argnums=(4, 5, 6))(
        params, tx.init(params), jb, jax.random.key(5), jagent, tx, jcfg,
        jnp.asarray(ent, jnp.float32))
    tm = GPTPolicy(tm0.cfg)
    tm.load_state_dict(tm0.state_dict())
    tst = tppo.train_step(tm, tppo.make_optimizer(tm, tcfg), tb, None,
                          tagent, tcfg, ent)
    assert set(tst) == set(jst)
    assert ("aux_loss" in tst) == (aux != "none")
    for k in jst:
        close(tst[k], jst[k], f"{aux} {k}", rtol=1e-4, atol=1e-6)
    moved = 0
    sd = tm.state_dict()
    for name, v in gpt_state_dict_from_flax(
            jax.tree.map(np.asarray, p2)).items():
        if name.endswith(NULL_DIRECTIONS):
            continue
        close(sd[name], v, f"{aux} param {name}", atol=1e-5)
        moved += int(not torch.equal(sd[name], tm0.state_dict()[name]))
    assert moved > 10
    # the aux heads move only under their loss term
    for head, terms in (("head_aux_rtm1", ("rtm1", "rtm1+rt", "all")),
                        ("head_aux_reward", ("rtm1+rt", "all")),
                        ("head_aux_transition", ("all",))):
        k = f"{head}.Dense_2.weight"
        assert torch.equal(sd[k], tm0.state_dict()[k]) == (aux not in terms)


def test_entropy_schedule():
    """``--ent-coeff-start`` at iteration 0, linear to ``--ent-coeff`` at
    ``--ent-anneal-iters``, constant after; 0 iterations of annealing hold
    ``--ent-coeff`` (the JAX trainer's ``ent_schedule`` closure,
    train_answer_given.py:244-253)."""
    a = argparse.Namespace(ent_coeff=0.01, ent_coeff_start=0.1,
                           ent_anneal_iters=1500)
    for i, want in ((0, 0.1), (750, 0.055), (1500, 0.01), (1999, 0.01)):
        v = a.ent_coeff_start + (a.ent_coeff - a.ent_coeff_start) * min(
            max(i / a.ent_anneal_iters, 0.0), 1.0)
        assert ttrain.ent_schedule(a, i) == v
        assert abs(v - want) < 1e-12
    a.ent_anneal_iters = 0
    assert ttrain.ent_schedule(a, 0) == ttrain.ent_schedule(a, 99) == 0.01
    d = ttrain.parse_args([])
    assert (d.ent_coeff, d.ent_coeff_start, d.ent_anneal_iters) == \
        (0.01, 0.1, 1500)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------
def cli_args(tmp_path, *extra):
    return ["--device", "cpu", "--n-tasks", "16", "--n-envs", "8",
            "--rollout", "8", "--episode-limit", "6", "--n-layer", "1",
            "--n-head", "2", "--n-embd", "32", "--epochs", "2",
            "--minibatches", "2", "--ckpt-every", "1",
            "--log-file", str(tmp_path / "log.jsonl"),
            "--ckpt-dir", str(tmp_path / "ckpt"), *extra]


def log_lines(tmp_path):
    return [json.loads(l) for l in open(tmp_path / "log.jsonl")]


def test_flags_match_the_jax_entry_point():
    """Every flag of the JAX trainer with its default, plus ``--device``
    (default ``cuda``)."""
    import ast
    import inspect
    from arcle_tpu.training import train_answer_given as jtrain
    flags = {}
    for node in ast.walk(ast.parse(inspect.getsource(jtrain.main))):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            name = kw["dest"].value if "dest" in kw else \
                node.args[0].value.lstrip("-").replace("-", "_")
            if "default" in kw:
                flags[name] = ast.literal_eval(kw["default"])
            elif "action" in kw:
                flags.setdefault(name, kw["action"].value != "store_true")
    d = vars(ttrain.parse_args([]))
    assert d.pop("device") == "cuda"
    assert d == flags


def test_main_smoke_and_resume(tmp_path):
    """``main`` on the CPU at a small size: a provenance header, finite
    losses and aux losses, the episode statistics, a checkpoint per
    iteration, moved params; ``--resume`` continues after the last; the
    evaluator reads the checkpoint in both modes."""
    pol = ttrain.main(cli_args(tmp_path, "--iterations", "2"))
    init = tag.make_policy(**SMALL, generator=torch.Generator().manual_seed(0))
    assert any(not torch.equal(a, b) for a, b in
               zip(pol.state_dict().values(), init.state_dict().values()))
    lines = log_lines(tmp_path)
    meta = lines[0]["meta"]
    assert meta["config"]["n_envs"] == 8 and "git_sha" in meta and \
        "--iterations" in meta["argv"]
    its = [l for l in lines if "iteration" in l]
    assert [l["iteration"] for l in its] == [0, 1]
    for l in its:
        for k in ("total_loss", "aux_loss", "aux_rtm1_loss", "aux_r_loss",
                  "aux_grid_loss", "success_rate", "episode_reward_mean",
                  "episode_len_mean"):
            assert np.isfinite(l[k]), k
        assert l["episodes"] >= 8 and l["rollout_ms"] > 0 and \
            l["update_ms"] > 0 and l["env_steps_per_s"] > 0
        # all 64 rewards of the window over its 8 finished episodes
        assert -8.0 <= l["episode_reward_mean"] <= 0.0
    ck = Checkpointer(str(tmp_path / "ckpt"))
    assert ck.steps() == [0, 1]
    saved = ck.restore()
    assert saved["iteration"] == 1
    assert all(torch.equal(v, pol.state_dict()[k])
               for k, v in saved["params"].items())

    pol3 = ttrain.main(cli_args(tmp_path, "--iterations", "3", "--resume"))
    assert [l["iteration"] for l in log_lines(tmp_path)
            if "iteration" in l] == [0, 1, 2]
    assert ck.steps() == [0, 1, 2]
    assert any(not torch.equal(a, b) for a, b in
               zip(pol3.state_dict().values(), pol.state_dict().values()))

    it, out = teval.main(["--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "ckpt"), "--n-envs", "8", "--steps",
                          "6", "--n-layer", "1", "--n-head", "2", "--n-embd",
                          "32"])
    assert it == 2 and set(out) == {"deterministic", "stochastic"}
    for m in out.values():
        assert 0.0 <= m["success_rate"] <= 1.0
        assert 0.0 <= m["mean_final_wrong"] <= 25.0
        assert set(m) == {"success_rate", "mean_final_wrong",
                          "mean_solve_len"}


def test_evaluator_scores_a_solving_policy(tmp_path, monkeypatch):
    """With ``sample_fn`` swapped for one that paints a wrong cell right
    on every step, both modes report success 1 and the solve length, on
    the bank of ``seed + 900001`` (disjoint from the training seed's)."""
    pol = tag.make_policy(**SMALL, colors=3)
    Checkpointer(str(tmp_path)).save(7, {"params": pol.state_dict(),
                                         "iteration": 7})
    seeds = []
    real_env = teval.answer_given_env

    def spy_env(**kw):
        seeds.append(kw["seed"])
        return real_env(**kw)

    def solver(model, **kw):
        agent = tag.answer_given_agent(model, **kw)

        def sample_fn(params, obs, generator=None, deterministic=False):
            grid, _, ans, _ = tag._unpack(obs, 5, 5)
            wrong = (grid != ans).reshape(-1, 25)
            cell = wrong.to(torch.int8).argmax(-1)
            r, c = cell // 5, cell % 5
            op = ans.reshape(-1, 25).gather(1, cell[:, None].long())[:, 0]
            acts = torch.stack([r, c, r, c, op.long()], 1).to(torch.int32)
            return acts, None, None
        return dataclasses.replace(agent, sample_fn=sample_fn)

    monkeypatch.setattr(teval, "answer_given_env", spy_env)
    monkeypatch.setattr(teval, "answer_given_agent", solver)
    it, out = teval.evaluate(str(tmp_path), n_envs=16, steps=26, colors=3,
                             seed=5, device="cpu", **SMALL)
    assert it == 7 and seeds == [5 + 900001]
    for m in out.values():
        assert m["success_rate"] == 1.0 and m["mean_final_wrong"] == 0.0
        assert 1.0 <= m["mean_solve_len"] <= 25.0


def test_continual_switches_banks(tmp_path):
    """``--continual``: five phases of ``--phase-iters`` iterations, the
    bank replaced and the envs reset at each switch, every phase's grids
    inside its palette."""
    seen = []

    def on_iteration(i, run, traj, stats):
        seen.append((stats["phase"], int(run.env.bank.in_grids.max()),
                     int(traj.obs[..., :25].max())))

    args = ttrain.parse_args(cli_args(
        tmp_path, "--continual", "--phase-iters", "1", "--iterations", "99",
        "--epochs", "1", "--minibatches", "1", "--aux", "none",
        "--ckpt-every", "0"))
    from arcle_tpu_torch.utils import MetricLogger
    ttrain.train(args, MetricLogger(None), on_iteration=on_iteration)
    assert [s[0] for s in seen] == [0, 1, 2, 3, 4]
    for (_, bank_max, obs_max), c in zip(seen, ttrain.CONTINUAL_COLORS):
        assert bank_max == c - 1
        # the policy may paint any of the 10 colours
        assert obs_max <= 9


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_cuda_without_card_raises(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "train":
            args = cli_args(tmp_path)
            ttrain.main(args[2:])              # the default device
        else:
            teval.main(["--ckpt-dir", str(tmp_path)])
