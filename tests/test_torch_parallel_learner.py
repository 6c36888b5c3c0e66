"""The data- and tensor-parallel PPO update (``arcle_tpu_torch.training.
ppo`` with ``group=``, ``arcle_tpu_torch.parallel.shard_params_tp``)
against the single-process port and against ``arcle_tpu``'s
``train_step``.

The ranks are Gloo process groups on the CPU: the rank functions below
(``_*_rank``) run in fresh processes started by
``arcle_tpu_torch.parallel.launch`` (each call with its own timeout) and
import no JAX; this module imports JAX inside the tests, and data crosses
over as ``.npz`` files.

Tolerances: the data-parallel update within 1e-5 (loss, relative; params,
absolute) of the single-process update, which sums in another order; the
tensor-parallel forward within 1e-6 of each output's largest magnitude,
and its update within 1e-5.
"""

import json
import os

import numpy as np
import torch

from arcle_tpu_torch.parallel import launch

HERE = os.path.abspath(__file__)
T, B = 4, 8                   # the learner's trajectory: 2 ranks x 4 envs
HIDDEN = (32, 32)
GPT_SMALL = dict(n_layer=1, n_head=2, n_embd=32, dtype=torch.float32,
                 embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)


# ---------------------------------------------------------------------------
# rank functions (run by arcle_tpu_torch.parallel.launch, no JAX)
# ---------------------------------------------------------------------------
def _policy(kind: str):
    from arcle_tpu_torch.models import FCPolicy, GPTConfig, GPTPolicy
    from arcle_tpu_torch.training import gpt_agent, mlp_agent
    if kind == "mlp":
        pol = FCPolicy(hidden=HIDDEN, n_ops=35)
        return pol, mlp_agent(pol)
    pol = GPTPolicy(GPTConfig(**GPT_SMALL))
    return pol, gpt_agent(pol)


def _traj(data, cols=slice(None)):
    from arcle_tpu_torch.training import Trajectory
    return Trajectory(**{f: torch.from_numpy(data[f][:, cols])
                         for f in Trajectory._fields}), \
        torch.from_numpy(data["last_value"][cols])


def _dp_rank(data_path: str, out_path: str, kind: str) -> None:
    """The data-parallel update on this rank's envs and, on rank 0, the
    single-process update on all of them, from the same weights and the
    same shuffle generator."""
    import torch.distributed as dist
    from arcle_tpu_torch.training import ppo

    data = np.load(data_path)
    cfg = ppo.PPOConfig(**json.loads(str(data["cfg"])))
    aux = cfg.aux_coeff > 0
    weights = {k[2:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("w:")}
    n, rank = dist.get_world_size(), dist.get_rank()
    b = data["last_value"].shape[0] // n
    out = {}
    for name, cols, group in (
            ("g", slice(rank * b, (rank + 1) * b), dist.group.WORLD),
            ("u", slice(None), None)):
        if group is None and rank != 0:
            continue
        pol, agent = _policy(kind)
        pol.load_state_dict(weights)
        traj, last = _traj(data, cols)
        batch = ppo.batch_from_trajectory(traj, last, cfg, include_aux=aux,
                                          group=group)
        stats = ppo.train_step(pol, ppo.make_optimizer(pol, cfg), batch,
                               torch.Generator().manual_seed(5), agent, cfg,
                               group=group, rollout_steps=T)
        out.update({f"{name}:stat:{k}": v.numpy() for k, v in stats.items()})
        out.update({f"{name}:param:{k}": v.detach().numpy()
                    for k, v in pol.state_dict().items()})
    if rank == 0:
        np.savez(out_path, **out)


def _tp_rank() -> None:
    """(data=1, model=2): a 1-layer GPT at width 128, column-parallel
    against the same weights whole, one forward and one update."""
    import copy

    import torch.distributed as dist
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.models import GPTConfig, GPTPolicy
    from arcle_tpu_torch.ops import o2arc_table
    from arcle_tpu_torch.parallel import data_model_mesh, shard_params_tp
    from arcle_tpu_torch.parallel.dryrun import _check_placement
    from arcle_tpu_torch.parallel.mesh import is_tp_sharded
    from arcle_tpu_torch.training import gpt_agent, ppo, rollout

    mesh = data_model_mesh(2, device_type="cpu")
    full = GPTPolicy(GPTConfig(n_layer=1, dtype=torch.float32),
                     torch.Generator().manual_seed(1))
    tp = shard_params_tp(copy.deepcopy(full), mesh, "model")
    _check_placement(tp, 2)
    agent = gpt_agent(full)
    env = BatchedEnv(table=o2arc_table(max_trial=3),
                     bank=SyntheticLoader(4, seed=0).bank(device="cpu"),
                     max_trial=3, episode_limit=10, auto_reset=True)
    bs = env.reset(torch.Generator().manual_seed(0), 2)
    obs = agent.obs_fn(bs.env)
    with torch.no_grad():
        want, got = agent.sample_fn(full, obs, deterministic=True), \
            agent.sample_fn(tp, obs, deterministic=True)
        fw = full(**_gpt_args(bs.env))
        ft = tp(**_gpt_args(bs.env))
    assert torch.equal(want[0], got[0]), "deterministic actions differ"
    worst_fwd = 0.0
    for k in fw:
        scale = max(float(fw[k].abs().max()), 1e-30)
        err = float((fw[k] - ft[k]).abs().max())
        assert err <= 1e-6 * scale, (k, err, scale)
        worst_fwd = max(worst_fwd, err / scale)

    _, traj, last = rollout(env, bs, full, torch.Generator().manual_seed(2),
                            2, agent)
    cfg = ppo.PPOConfig()
    batch = ppo.batch_from_trajectory(traj, last, cfg)
    ppo.train_step(full, ppo.make_optimizer(full, cfg), batch, None, agent,
                   cfg)
    ppo.train_step(tp, ppo.make_optimizer(tp, cfg), batch, None, agent, cfg,
                   group=mesh.get_group("data"), rollout_steps=2)
    _check_placement(tp, 2)
    group, index = mesh.get_group("model"), mesh.get_local_rank("model")
    worst = 0.0
    for (name, p), (_, q) in zip(full.named_parameters(),
                                 tp.named_parameters()):
        if is_tp_sharded(q):
            parts = [torch.empty_like(q) for _ in range(2)]
            dist.all_gather(parts, q.detach(), group=group)
            q = torch.cat(parts)
            assert torch.equal(parts[index], tp.get_parameter(name).detach())
        err = float((p.detach() - q.detach()).abs().max())
        assert err <= 1e-5, (name, err)
        worst = max(worst, err)
    if dist.get_rank() == 0:
        print(f"TP forward {worst_fwd:.3e} update {worst:.3e}", flush=True)


def _gpt_args(st):
    return dict(grid=st.grid, grid_dim=st.grid_dim, inp=st.input,
                inp_dim=st.input_dim, trials_remain=st.trials_remain,
                active=st.active)


# ---------------------------------------------------------------------------
# the data-parallel learner
# ---------------------------------------------------------------------------
def _trajectory(pol, agent, rng):
    """A ``[T, B]`` trajectory of real observations (reset O2ARCv2 envs),
    random valid actions, behaviour log-probs near the policy's, and
    rewards, dones and truncation bootstraps made with numpy."""
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table

    env = BatchedEnv(table=o2arc_table(max_trial=3),
                     bank=SyntheticLoader(6, seed=1).bank(device="cpu"),
                     max_trial=3, episode_limit=10, auto_reset=True)
    st = env.reset(torch.Generator().manual_seed(4), T * B).env
    obs = agent.obs_fn(st)
    acts = np.concatenate([np.sort(rng.integers(0, 30, (T * B, 2, 2)), 1)
                           .transpose(0, 2, 1).reshape(-1, 4),
                           rng.integers(0, 35, (T * B, 1))], 1)
    acts = torch.from_numpy(acts[:, [0, 2, 1, 3, 4]].astype(np.int32))
    with torch.no_grad():
        lp, _, _ = agent.evaluate_fn(pol, obs, acts)
    dones = rng.random((T, B)) < 0.25
    term = dones & (rng.random((T, B)) < 0.5)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        obs=obs.numpy().reshape(T, B, -1), actions=acts.numpy().reshape(
            T, B, 5),
        log_probs=f32(lp.numpy().reshape(T, B)
                      + rng.normal(0, 0.05, (T, B))),
        values=f32(rng.normal(0, 0.5, (T, B))),
        rewards=f32(rng.choice([0.0, 0.1, 1.0], (T, B))), dones=dones,
        terminated=term,
        final_values=f32(np.where(dones & ~term,
                                  rng.normal(0, 0.5, (T, B)), 0.0)),
        last_value=f32(rng.normal(0, 0.5, B)))


def _run_dp(tmp_path, kind, cfg_kw, weights, traj):
    data = dict(traj, cfg=json.dumps(cfg_kw),
                **{f"w:{k}": v.numpy() for k, v in weights.items()})
    np.savez(tmp_path / f"{kind}.npz", **data)
    launch.spawn(f"{HERE}:_dp_rank", 2, "cpu",
                 (tmp_path / f"{kind}.npz", tmp_path / f"{kind}_out.npz",
                  kind), timeout_s=300)
    return np.load(tmp_path / f"{kind}_out.npz")


def _assert_dp_equals_single(out, params_atol=1e-5):
    stats = [k[len("u:stat:"):] for k in out.files if k.startswith("u:stat")]
    assert "total_loss" in stats
    for k in stats:
        np.testing.assert_allclose(out[f"g:stat:{k}"], out[f"u:stat:{k}"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in out.files:
        if k.startswith("u:param:"):
            got, want = out["g:" + k[2:]], out[k]
            # A softmax does not move when all its inputs shift alike, so
            # the gradients of the key bias (every score of a row) and of
            # the op head's last bias (every op logit) are zero up to
            # rounding, and Adam turns that rounding into steps of +-lr in
            # either summation order (ROADMAP queue 3).  Those entries are
            # left out.
            if k.endswith("qkv.bias"):
                C = got.shape[0] // 3
                got, want = np.delete(got, np.s_[C:2 * C]), \
                    np.delete(want, np.s_[C:2 * C])
            if k.endswith("head_operation.Dense_2.bias"):
                continue
            np.testing.assert_allclose(got, want, rtol=0, atol=params_atol,
                                       err_msg=k)


def test_dp_update_matches_single_and_jax(tmp_path):
    """1 epoch x 1 minibatch, the MLP: the 2-rank update equals the
    single-process port's and JAX's ``train_step`` from carried weights
    (the clip engages: the gradient norm exceeds 0.5)."""
    import importlib

    import jax
    from arcle_tpu.models.mlp import FCPolicy as JFCPolicy
    from arcle_tpu_torch.models import fcpolicy_state_dict_from_flax
    jagents = importlib.import_module("arcle_tpu.training.agents")
    jppo = importlib.import_module("arcle_tpu.training.ppo")
    jroll = importlib.import_module("arcle_tpu.training.rollout")

    cfg_kw = dict(max_grad_norm=0.5)
    jagent = jagents.mlp_agent(JFCPolicy(hidden=HIDDEN, n_ops=35))
    pol, agent = _policy("mlp")
    traj = _trajectory(pol, agent, np.random.default_rng(0))
    params = jagent.init_fn(jax.random.key(1), traj["obs"][0, :1]
                            .astype(np.float32))
    weights = fcpolicy_state_dict_from_flax(jax.tree.map(np.asarray, params))
    pol.load_state_dict(weights)
    traj = _trajectory(pol, agent, np.random.default_rng(0))
    out = _run_dp(tmp_path, "mlp", cfg_kw, weights, traj)
    _assert_dp_equals_single(out)

    jcfg = jppo.PPOConfig(**cfg_kw)
    jtraj = jroll.Trajectory(**{
        f: traj[f].astype(np.float32) if f == "obs" else traj[f]
        for f in jroll.Trajectory._fields})
    jb = jppo.batch_from_trajectory(jtraj, traj["last_value"], jcfg)
    tx = jppo.make_optimizer(jcfg)
    p2, _, jst = jax.jit(jppo.train_step, static_argnums=(4, 5, 6))(
        params, tx.init(params), jb, jax.random.key(5), jagent, tx, jcfg)
    np.testing.assert_allclose(out["g:stat:total_loss"],
                               np.asarray(jst["total_loss"]), rtol=1e-5)
    for k, v in fcpolicy_state_dict_from_flax(
            jax.tree.map(np.asarray, p2)).items():
        np.testing.assert_allclose(out[f"g:param:{k}"], v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_dp_update_shuffled_with_aux_matches_single(tmp_path):
    """2 epochs x 4 minibatches with the GPT's aux losses: the 2-rank
    update equals the single-process port's under the same permutations
    (the minibatches split unevenly across the ranks)."""
    pol, agent = _policy("gpt")
    cfg_kw = dict(n_epochs=2, n_minibatches=4, aux_coeff=0.1, lr=1e-3)
    traj = _trajectory(pol, agent, np.random.default_rng(1))
    out = _run_dp(tmp_path, "gpt", cfg_kw, pol.state_dict(), traj)
    assert "aux_grid_loss" in {k.rsplit(":", 1)[1] for k in out.files}
    _assert_dp_equals_single(out)


def test_tp_forward_and_update_match_unsharded():
    outs = launch.spawn(f"{HERE}:_tp_rank", 2, "cpu", timeout_s=300)
    assert "TP forward" in outs[0], outs
