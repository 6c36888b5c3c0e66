"""E-MAML's step under a data-parallel group (``emaml_train_step`` and
``make_chunked_train_step`` with ``group=``, ``run_emaml(group=)``)
against ``arcle_tpu``'s unsharded step.

The ranks are Gloo process groups on the CPU, started by
``arcle_tpu_torch.parallel.launch``; the rank functions below (``_*_rank``)
import no JAX.  The JAX step runs once per case in this process, on the
fixed trajectories of ``tests/test_torch_emaml.py`` (``task_rollout``
swapped for a function handing them out); each rank's ``task_rollout``
hands out its columns of the same trajectories.  Two layouts: 2 tasks
whole on 2 ranks, and 2 tasks split over 4 ranks (each rank one env of
one task, the layout of ``tests/test_sharding.py``'s sharded E-MAML test).

Tolerances, as ``tests/test_torch_emaml.py``'s: float metrics rtol 1e-4
/ atol 1e-6, params atol 1e-5; integer metrics, the KL ladder and the
task bookkeeping exact; every rank's params, ladder and bookkeeping
bit-identical to every other rank's.
"""

import json
import os

import numpy as np
import pytest
import torch

from arcle_tpu_torch.parallel import launch

HERE = os.path.abspath(__file__)
BASE = dict(n_tasks=2, envs_per_task=2, rollout_steps=4, inner_steps=2,
            maml_opt_steps=2, inner_lr=0.05, meta_lr=1e-3)
CASES = {
    "fused_first_order": dict(first_order=True),
    "fused_second_order": dict(first_order=False),
    "chunked_cached_micro2": dict(first_order=True, chunked=True,
                                  cache_chain=True, n_micro=2),
}
LAYOUTS = {"whole-2ranks": 2, "split-4ranks": 4}


# ---------------------------------------------------------------------------
# rank functions (run by arcle_tpu_torch.parallel.launch, no JAX)
# ---------------------------------------------------------------------------
def _emaml_rank(data_path: str, out_dir: str) -> None:
    """Every case's step under the world group, on this rank's columns of
    the trajectories; writes ``rank<r>.npz``."""
    import torch.distributed as dist
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.models import FCPolicy
    from arcle_tpu_torch.ops import o2arc_table
    from arcle_tpu_torch.parallel.mesh import task_layout
    from arcle_tpu_torch.training import emaml, mlp_agent
    from arcle_tpu_torch.training.rollout import Trajectory

    data = np.load(data_path)
    n_rollouts = BASE["inner_steps"] + 1
    layout = task_layout(BASE["n_tasks"], BASE["envs_per_task"],
                         dist.group.WORLD)
    cols = layout.rows
    weights = {k[2:]: torch.from_numpy(data[k]) for k in data.files
               if k.startswith("w:")}
    out = {"tasks": np.array(list(layout.tasks))}
    for name, kw in CASES.items():
        cfg = emaml.EMAMLConfig(**BASE, **kw)
        agent = mlp_agent(FCPolicy(hidden=(16,), n_ops=35))
        calls = []

        def fake_rollout(env, bs, task_params, gen, agent_, cfg_,
                         deterministic):
            i = len(calls)
            calls.append(deterministic)
            traj = Trajectory(**{
                f: torch.from_numpy(data[f"r{i}:{f}"][:, cols])
                for f in Trajectory._fields})
            return bs, traj, torch.from_numpy(data[f"r{i}:last_v"][cols])

        opts = ResetOptions.make(
            prob_index=torch.from_numpy(data["assign"][cols]), device="cpu")
        env = BatchedEnv(table=o2arc_table(7, crop_at_33=True),
                         bank=SyntheticLoader(6, seed=2).bank(device="cpu"),
                         max_trial=7, episode_limit=8, auto_reset=True,
                         opts=opts)
        bs = env.reset(torch.Generator().manual_seed(0),
                       cols.stop - cols.start)
        st = emaml.init_emaml(agent, cfg, 0, n_bank_tasks=6, device="cpu")
        st.params.load_state_dict(weights)
        real = emaml.task_rollout
        emaml.task_rollout = fake_rollout
        try:
            if cfg.chunked:
                step = emaml.make_chunked_train_step(agent, cfg,
                                                     group=layout)
                st, _, m = step(st, env, bs)
            else:
                st, _, m = emaml.emaml_train_step(st, env, bs, agent, cfg,
                                                  group=layout)
        finally:
            emaml.task_rollout = real
        assert calls == [False] * (n_rollouts - 1) + [True], calls
        full = emaml.all_task_rows(layout, m["post_batch"],
                                   cfg.rollout_steps)
        for k, v in m.items():
            if k == "post_batch":
                for f, x in v._asdict().items():
                    if x is not None:
                        out[f"{name}:local:{f}"] = x.numpy()
                        out[f"{name}:full:{f}"] = getattr(full, f).numpy()
            else:
                out[f"{name}:m:{k}"] = v.detach().numpy()
        out.update({f"{name}:p:{k}": v.numpy()
                    for k, v in st.params.state_dict().items()})
        out[f"{name}:kl_coeffs"] = st.kl_coeffs.numpy()
        out[f"{name}:covered"] = st.tasks_covered.numpy()
        out[f"{name}:succeeded"] = st.tasks_succeeded.numpy()
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)


def _real_rank(out_dir: str) -> None:
    """``run_emaml(group=WORLD)`` for one meta-iteration with real
    rollouts; records the rows and tasks each rollout stepped."""
    import torch.distributed as dist
    from arcle_tpu_torch.training import emaml
    from arcle_tpu_torch.training.emaml import EMAMLConfig
    from arcle_tpu_torch.training.train import run_emaml
    from arcle_tpu_torch.utils import EnvConfig, MetricLogger, RunConfig

    rank = dist.get_rank()
    cfg = RunConfig(
        seed=3, algo="emaml", total_iterations=1, checkpoint_every=1,
        checkpoint_dir=os.path.join(out_dir, f"ck{rank}"), device="cpu",
        env=EnvConfig(family="o2arc_crop33", max_trial=7, episode_limit=6,
                      dataset="synthetic", n_synthetic_tasks=6,
                      dense_reward=True, augment=True, reset_pool=4),
        emaml=EMAMLConfig(n_tasks=2, envs_per_task=8, rollout_steps=6,
                          inner_steps=2, maml_opt_steps=1, first_order=True),
        mlp_hidden=(16,))
    seen, out = [], {}
    real = emaml.task_rollout

    def recording_rollout(env, bs, *args):
        seen.append((bs.batch, env.opts.prob_index.tolist()))
        return real(env, bs, *args)

    def on_iteration(i, st, m):
        out.update({f"p:{k}": v.numpy()
                    for k, v in st.params.state_dict().items()})
        out.update(meta_loss=m["meta_loss"].numpy(),
                   sampled=m["sampled_tasks"].numpy(),
                   kl_coeffs=st.kl_coeffs.numpy(),
                   covered=st.tasks_covered.numpy(),
                   succeeded=st.tasks_succeeded.numpy())

    logger = MetricLogger(os.path.join(out_dir, f"log{rank}.jsonl"))
    emaml.task_rollout = recording_rollout
    try:
        run_emaml(cfg, logger, on_iteration=on_iteration,
                  group=dist.group.WORLD)
    finally:
        emaml.task_rollout = real
        logger.close()
    out["rows"] = np.array([b for b, _ in seen])
    out["prob"] = np.array([p for _, p in seen])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The trajectories, the weights and JAX's unsharded step for every
    case, computed once."""
    import jax
    import jax.numpy as jnp
    from test_torch_emaml import (
        JFCPolicy, flax_to_state, jagents, jemaml, jppo, make_trajectories,
        run_jax)

    jag = jagents.mlp_agent(JFCPolicy(hidden=(16,), n_ops=35))
    params = jag.init_fn(jax.random.key(1), jnp.zeros((1, 2710), jnp.int8))
    trajs = make_trajectories(np.random.default_rng(0), params, jag,
                              BASE["inner_steps"] + 1)
    assign = np.repeat(np.array([4, 1], np.int32), BASE["envs_per_task"])
    data = {"assign": assign}
    for i, t in enumerate(trajs):
        data.update({f"r{i}:{f}": v for f, v in t["traj"].items()})
        data[f"r{i}:last_v"] = t["last_v"]
    data.update({f"w:{k}": v.numpy()
                 for k, v in flax_to_state(params).items()})
    path = tmp_path_factory.mktemp("emaml_dp") / "data.npz"
    np.savez(path, **data)
    ref = {}
    for name, kw in CASES.items():
        cfg = jemaml.EMAMLConfig(**BASE, **kw, ppo=jppo.PPOConfig())
        st, m = run_jax(cfg, params, trajs, assign)
        ref[name] = dict(
            m={k: np.asarray(v) for k, v in m.items() if k != "post_batch"},
            post={f: np.asarray(x) for f, x in m["post_batch"]._asdict()
                  .items() if x is not None},
            params={k: v.numpy() for k, v in flax_to_state(st.params)
                    .items()},
            kl_coeffs=np.asarray(st.kl_coeffs),
            covered=np.asarray(st.tasks_covered),
            succeeded=np.asarray(st.tasks_succeeded))
    return path, ref


def _local_rows(x, tasks, rank, n_ranks):
    """This rank's rows of JAX's ``[tasks, steps * envs, ...]`` batch."""
    T, E, S = BASE["n_tasks"], BASE["envs_per_task"], BASE["rollout_steps"]
    if n_ranks <= T:
        return x[tasks[0]:tasks[-1] + 1]
    k = n_ranks // T
    per = E // k
    e0 = (rank % k) * per
    x = x.reshape((T, S, E) + x.shape[2:])[tasks[0]:tasks[0] + 1, :,
                                           e0:e0 + per]
    return x.reshape((1, S * per) + x.shape[3:])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_emaml_dp_matches_jax(layout, jax_reference, tmp_path):
    from test_torch_emaml import FLOAT_METRICS, INT_METRICS
    path, ref = jax_reference
    n = LAYOUTS[layout]
    launch.spawn(f"{HERE}:_emaml_rank", n, "cpu", (path, tmp_path),
                 timeout_s=300)
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(n)]
    for r, out in enumerate(outs):
        for name, want in ref.items():
            for k in FLOAT_METRICS:
                np.testing.assert_allclose(
                    out[f"{name}:m:{k}"], want["m"][k], rtol=1e-4, atol=1e-6,
                    err_msg=f"{layout} rank {r} {name} {k}")
            for k in INT_METRICS:
                np.testing.assert_array_equal(
                    out[f"{name}:m:{k}"], want["m"][k],
                    f"{layout} rank {r} {name} {k}")
            for f, x in want["post"].items():
                np.testing.assert_allclose(
                    out[f"{name}:local:{f}"],
                    _local_rows(x, out["tasks"], r, n), rtol=1e-5,
                    atol=1e-6, err_msg=f"{layout} rank {r} {name} local {f}")
                np.testing.assert_allclose(
                    out[f"{name}:full:{f}"], x, rtol=1e-5, atol=1e-6,
                    err_msg=f"{layout} rank {r} {name} full {f}")
            for k, v in want["params"].items():
                np.testing.assert_allclose(
                    out[f"{name}:p:{k}"], v, rtol=0, atol=1e-5,
                    err_msg=f"{layout} rank {r} {name} param {k}")
            for k in ("kl_coeffs", "covered", "succeeded"):
                np.testing.assert_array_equal(out[f"{name}:{k}"], want[k],
                                              f"{layout} {name} {k}")
            assert not np.all(want["kl_coeffs"] == 0.0005)   # it moved
        # every rank ends bit-identical to the first
        for k in outs[0].files:
            if ":p:" in k or k.endswith(("kl_coeffs", "covered",
                                         "succeeded")):
                np.testing.assert_array_equal(out[k], outs[0][k],
                                              f"rank {r} vs 0: {k}")


def test_emaml_dp_real_rollouts_two_ranks(tmp_path):
    """``tests/test_sharding.py``'s sharded E-MAML configuration (2 tasks x
    8 envs, pool 4, augment, dense reward, episode_limit 6) through
    ``run_emaml(group=)`` on 2 ranks: each rank steps its task's 8 envs,
    the ranks end identical, and only the first rank logs and writes the
    checkpoint, which holds both ranks' rollout generators."""
    launch.spawn(f"{HERE}:_real_rank", 2, "cpu", (tmp_path,),
                 timeout_s=300)
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    task_of = outs[0]["sampled"]
    for r, out in enumerate(outs):
        assert out["rows"].tolist() == [8] * 3          # 2 inner + post
        assert (out["prob"] == task_of[r]).all(), (r, out["prob"])
        assert np.isfinite(out["meta_loss"])
        for k in out.files:
            if k not in ("rows", "prob"):
                np.testing.assert_array_equal(out[k], outs[0][k],
                                              f"rank {r}: {k}")
    assert task_of[0] != task_of[1]
    lines = (tmp_path / "log0.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["iteration"] == 0
    assert (tmp_path / "log1.jsonl").read_text() == ""
    assert os.listdir(tmp_path / "ck1") == []
    (ckpt,) = os.listdir(tmp_path / "ck0")
    gens = torch.load(tmp_path / "ck0" / ckpt,
                      weights_only=True)["state_generators"]
    assert len(gens) == 2 and not torch.equal(gens[0], gens[1])


@pytest.mark.parametrize("n_tasks,envs,ranks", [
    (2, 4, 3),          # 3 ranks neither divide 2 tasks nor are divided
    (2, 3, 4),          # 2 ranks per task cannot split 3 envs
    (4, 2, 6),          # 6 ranks for 4 tasks
    (3, 8, 2),          # 2 ranks do not divide 3 tasks
])
def test_task_layout_refuses(n_tasks, envs, ranks):
    from unittest import mock

    from arcle_tpu_torch.parallel import mesh
    with mock.patch.object(mesh.dist, "get_world_size", return_value=ranks), \
            mock.patch.object(mesh.dist, "get_rank", return_value=0):
        with pytest.raises(ValueError, match=f"{n_tasks} tasks of {envs} "
                                             f"envs do not lie on {ranks} "
                                             f"ranks"):
            mesh.task_layout(n_tasks, envs, group=object())
