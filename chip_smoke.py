#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA engine on one GPU.

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:

1. device  -- needs CUDA; prints the card's name and power limit;
2. build   -- compiles csrc/step_kernel.cu with nvcc and loads it;
3. parity  -- the step kernel against its plain PyTorch version (plus the
              flood fix-up) on the same CUDA inputs: B=4096, 30 fuzz steps
              on o2arc_table (with and without crop_at_33), arc_table and
              raw_table; every state field, the reward and `terminated`
              bit-exact;
4. engine  -- BatchedEnv on CUDA against the same engine on the CPU, same
              start, pool and actions, 256 envs x 40 steps across
              auto-resets: carry, obs, reward, term, trunc bit-exact;
5. main    -- the O2ARCv2 main path: 4096 envs, random bbox actions,
              episode_limit=100, auto-reset from an 8-deep pool; 100 steps
              after a warm-up rollout, with the kernel's launch count,
              auto-reset and the checksum asserted;
   learner -- the PPO learner at full width on the card against the same
              learner on the CPU: one 2048-row batch from a short CUDA
              rollout of the train configuration, the same weights; loss,
              stats, every gradient and the params after one clip+Adam
              step compared;
   train   -- the training main path through ``run_ppo``: 4096 envs,
              T=100, the full-width FCPolicy, one warm-up and 3 timed
              iterations; 100 kernel launches per iteration, finite
              losses, moving params, auto-resets and the TimeLimit
              bootstrap asserted; ms/iter, env-steps/s including the
              learner, the rollout / update split and the peak memory;
6. timing  -- CUDA-event times of the kernel and of its plain version per
              step at B=4096, and of the 100-step loop through each.

It then prints a JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}.  Any failure raises: the script exits
non-zero and prints no result.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import subprocess
import sys
import time
import types

import torch

B = 4096
PARITY_STEPS = 30
MAIN_STEPS = 100


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fuzz_actions(gen, batch, n_ops, H, W, dev):
    """Ops in [-1, n_ops] (clipping included) and selections mixing empty,
    single-pixel, box and sparse random 0/1 masks."""
    from arcle_tpu_torch.core import Action, bbox_selection, point_selection
    I32 = torch.int32
    ops = torch.randint(-1, n_ops + 1, (batch,), generator=gen, device=dev,
                        dtype=I32)
    style = torch.randint(0, 4, (batch,), generator=gen, device=dev)
    c = torch.randint(0, H, (4, batch), generator=gen, device=dev, dtype=I32)
    box = bbox_selection(c[0], c[1], c[2], c[3], H, W)
    pix = point_selection(c[0], c[1], H, W)
    sparse = (torch.rand((batch, H, W), generator=gen, device=dev)
              < 0.08).to(torch.int8)
    s = style.view(-1, 1, 1)
    sel = torch.where(s == 1, pix, torch.where(
        s == 2, box, torch.where(s == 3, sparse, torch.zeros_like(box))))
    return Action(selection=sel.contiguous(), operation=ops)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def phase_parity(dev) -> float:
    from arcle_tpu_torch.core import FIELDS
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import (
        o2arc_table, arc_table, raw_table, finish_flood)
    from arcle_tpu_torch.ops.step_kernel import (
        cuda_step_deferred, plain_step_deferred)

    bank = SyntheticLoader(16, seed=3).bank(device=dev)
    gen = torch.Generator(device=dev)
    # a quarter of the envs re-init on Submit
    ros = torch.arange(B, device=dev) % 4 == 0
    worst = 0.0
    tables = [("o2arc", o2arc_table(max_trial=3)),
              ("o2arc_crop33", o2arc_table(max_trial=3, crop_at_33=True)),
              ("arc", arc_table(max_trial=3)), ("raw", raw_table(max_trial=3))]
    for ti, (name, table) in enumerate(tables):
        env = BatchedEnv(table=table, bank=bank, max_trial=3,
                         opts=ResetOptions.make(reset_on_submit=ros,
                                                device=dev))
        gen.manual_seed(100 + ti)
        st = env.reset(gen, B).env
        n_pending = 0
        for t in range(PARITY_STEPS):
            act = fuzz_actions(gen, B, table.n_ops, 30, 30, dev)
            ks, kr, kt, kp = cuda_step_deferred(st, act, table)
            ps, pr, pt, pp = plain_step_deferred(st, act, table)
            if bool(pp.any()):
                n_pending += int(pp.sum())
                ps = finish_flood(ps, act, table, pp)
            pairs = [(f, getattr(ks, f), getattr(ps, f)) for f in FIELDS]
            pairs += [("reward", kr, pr), ("terminated", kt, pt),
                      ("pending", kp, torch.zeros_like(kp))]
            for field, k, p in pairs:
                if not torch.equal(k, p):
                    bad = (k != p).reshape(B, -1).any(dim=1).nonzero()
                    raise AssertionError(
                        f"parity: table {name} step {t} field {field} "
                        f"differs in {bad.numel()} envs, first {bad[:5, 0]}")
                worst = max(worst, max_abs_diff(k, p))
            st = ps
        torch.cuda.synchronize()
        log(f"parity {name}: B={B} steps={PARITY_STEPS} bit-exact "
            f"(deferred floods finished by the plain fix-up: {n_pending})")
    return worst


def phase_engine(dev):
    """BatchedEnv on CUDA (kernel) against BatchedEnv on the CPU (plain)."""
    from arcle_tpu_torch.core import FIELDS
    from arcle_tpu_torch.envs import BatchedEnv, random_bbox_actions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table
    from arcle_tpu_torch.envs.core import BatchedState

    n, steps = 256, 40
    bank = SyntheticLoader(16, seed=3).bank()
    mk = lambda b: BatchedEnv(table=o2arc_table(max_trial=-1), bank=b,
                              max_trial=-1, episode_limit=12,
                              auto_reset=True, reset_pool=3)
    env_c, env_g = mk(bank), mk(bank.to(dev))
    bs_c = env_c.reset(torch.Generator().manual_seed(7), n)
    to_dev = lambda s, d: type(s)(**{f.name: getattr(s, f.name).to(d)
                                     for f in dataclasses.fields(s)})
    bs_g = BatchedState(env=to_dev(bs_c.env, dev),
                        generator=torch.Generator(device=dev),
                        pool=to_dev(bs_c.pool, dev))
    gen = torch.Generator(device=dev).manual_seed(8)
    for t in range(steps):
        act = random_bbox_actions(gen, n, 35, 30, 30, dev)
        act_c = type(act)(selection=act.selection.cpu(),
                          operation=act.operation.cpu())
        bs_g, obs_g, r_g, te_g, tr_g = env_g.step(bs_g, act)
        bs_c, obs_c, r_c, te_c, tr_c = env_c.step(bs_c, act_c)
        checks = [("reward", r_g, r_c), ("term", te_g, te_c),
                  ("trunc", tr_g, tr_c),
                  ("pool.counter", bs_g.pool.counter, bs_c.pool.counter)]
        checks += [(f"obs.{f}", getattr(obs_g, f), getattr(obs_c, f))
                   for f in FIELDS]
        checks += [(f"carry.{f}", getattr(bs_g.env, f), getattr(bs_c.env, f))
                   for f in FIELDS]
        for name, g, c in checks:
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"engine: step {t} {name} differs")
    resets = int(bs_c.pool.counter.sum())
    if resets < n:
        raise AssertionError(f"engine: only {resets} auto-resets")
    log(f"engine: BatchedEnv cuda vs cpu, {n} envs x {steps} steps, "
        f"{resets} auto-resets, bit-exact")


def main_env(dev):
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table
    return BatchedEnv(table=o2arc_table(max_trial=-1),
                      bank=SyntheticLoader(16, seed=3).bank(device=dev),
                      max_trial=-1, episode_limit=100, auto_reset=True,
                      reset_pool=8)


def phase_main(dev):
    from arcle_tpu_torch.envs import random_bbox_rollout
    from arcle_tpu_torch.ops import step_kernel

    env = main_env(dev)
    bs = env.reset(torch.Generator(device=dev).manual_seed(0), B)
    act_gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    bs, chk = random_bbox_rollout(env, bs, MAIN_STEPS, act_gen)   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ctr0 = bs.pool.counter.clone()

    step_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    bs, chk = random_bbox_rollout(env, bs, MAIN_STEPS, act_gen)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = step_kernel.LAUNCHES

    if launches != MAIN_STEPS:
        raise AssertionError(f"main: {launches} kernel launches for "
                             f"{MAIN_STEPS} steps")
    resets = bs.pool.counter - ctr0
    if not bool((resets >= 1).all()):
        raise AssertionError("main: some envs never auto-reset")
    chk_v = float(chk)
    if chk_v != chk_v or chk_v in (float("inf"), float("-inf")):
        raise AssertionError(f"main: checksum {chk_v} is not finite")
    st = bs.env
    if tuple(st.grid.shape) != (B, 30, 30) or st.grid.dtype != torch.int8:
        raise AssertionError(f"main: grid {tuple(st.grid.shape)} "
                             f"{st.grid.dtype}")
    if not bool(((st.steps >= 0) & (st.steps < 100)).all()):
        raise AssertionError("main: step counters outside [0, 100)")
    log(f"main: O2ARCv2 {B} envs x {MAIN_STEPS} steps, launches={launches}, "
        f"auto-resets={int(resets.sum())} (every env), checksum={int(chk)}, "
        f"warm-up {warm_s:.3f} s, run {run_s:.3f} s (host clock)")
    return launches


def train_config(device: str, n_envs: int, iterations: int):
    """``bench.py::bench_train_loop``'s configuration: O2ARCv2 with CropGrid
    at op 33, max_trial=127, episode_limit=100, dense reward,
    augmentation, an 8-deep reset pool, SyntheticLoader(32, seed=7), the
    full-width FCPolicy and PPOConfig() (one full-batch update)."""
    from arcle_tpu_torch.utils import RunConfig, EnvConfig
    return RunConfig(seed=0, algo="ppo", model="mlp",
                     total_iterations=iterations, checkpoint_every=0,
                     device=device,
                     env=EnvConfig(family="o2arc_crop33", max_trial=127,
                                   episode_limit=100, n_envs=n_envs,
                                   dataset="synthetic", n_synthetic_tasks=32,
                                   dense_reward=True, augment=True,
                                   reset_pool=8),
                     mlp_hidden=(1024, 1024, 512, 512, 256, 128))


def phase_learner(dev):
    """The learner on the card against the learner on the CPU, full width,
    on one batch of 2048 rows from a short CUDA rollout."""
    from arcle_tpu_torch.training import (
        rollout, batch_from_trajectory, ppo_loss, train_step, make_optimizer)
    from arcle_tpu_torch.training.train import setup_ppo

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("learner: float32 matmuls are not full float32 "
                             "(TF32 is on)")
    run = setup_ppo(train_config("cuda", 256, 1))
    _, traj, last_v = rollout(run.env, run.bs, run.params, run.generator, 8,
                              run.agent)
    cfg = run.cfg.ppo
    batch_g = batch_from_trajectory(traj, last_v, cfg)
    batch_c = type(batch_g)(*(None if x is None else x.cpu()
                              for x in batch_g))
    pol_g = run.params
    pol_c = copy.deepcopy(pol_g).cpu()

    out = {}
    for name, pol, batch in (("cuda", pol_g, batch_g), ("cpu", pol_c,
                                                         batch_c)):
        pol.zero_grad(set_to_none=True)
        loss, stats = ppo_loss(pol, run.agent, batch, cfg)
        loss.backward()
        out[name] = ({k: v.detach().cpu() for k, v in stats.items()},
                     {k: p.grad.detach().cpu()
                      for k, p in pol.named_parameters()})
    (st_g, gr_g), (st_c, gr_c) = out["cuda"], out["cpu"]
    worst_grad = 0.0
    for k in st_c:
        torch.testing.assert_close(st_g[k], st_c[k], rtol=1e-4, atol=1e-6,
                                   msg=f"learner: stat {k}")
    for k in gr_c:
        torch.testing.assert_close(gr_g[k], gr_c[k], rtol=1e-3, atol=1e-5,
                                   msg=f"learner: grad {k}")
        worst_grad = max(worst_grad, max_abs_diff(gr_g[k], gr_c[k]))
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for g in gr_c.values()))

    opts = {"cuda": run.opt, "cpu": make_optimizer(pol_c, cfg)}
    for name, pol, batch in (("cuda", pol_g, batch_g), ("cpu", pol_c,
                                                         batch_c)):
        train_step(pol, opts[name], batch, None, run.agent, cfg)
    worst_param = 0.0
    sd_c = pol_c.state_dict()
    for k, v in pol_g.state_dict().items():
        torch.testing.assert_close(v.cpu(), sd_c[k], rtol=0, atol=1e-5,
                                   msg=f"learner: param {k} after the step")
        worst_param = max(worst_param, max_abs_diff(v.cpu(), sd_c[k]))
    log(f"learner: cuda vs cpu, FCPolicy hidden={pol_g.hidden}, "
        f"N={batch_g.obs.shape[0]} rows: loss {float(st_g['total_loss']):.6f}"
        f" vs {float(st_c['total_loss']):.6f}, worst grad diff "
        f"{worst_grad:.3e}, grad norm {norm:.4f} (clip at "
        f"{cfg.max_grad_norm}: {'on' if norm >= cfg.max_grad_norm else 'off'}"
        f"), worst param diff after clip+Adam {worst_param:.3e}; TF32 off")


def phase_train(dev, card: str):
    """``run_ppo`` at ``bench_train_loop``'s configuration: one warm-up and
    three timed iterations."""
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.training.train import run_ppo, build_agent
    from arcle_tpu_torch.utils import MetricLogger

    iters, T = 4, 100
    cfg = train_config("cuda", B, iters)
    init = build_agent(cfg).init_fn(torch.Generator().manual_seed(cfg.seed))
    rows = []

    def on_iteration(i, run, traj, stats):
        launches = step_kernel.LAUNCHES - sum(r["launches"] for r in rows)
        if launches != T:
            raise AssertionError(f"train: iteration {i} launched the step "
                                 f"kernel {launches} times, not {T}")
        loss = float(stats["total_loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"train: iteration {i} loss {loss}")
        if not bool(traj.dones.any(0).all()):
            raise AssertionError(f"train: iteration {i}: some envs never "
                                 "auto-reset")
        need = traj.dones & ~traj.terminated
        if bool((traj.final_values[~need] != 0).any()):
            raise AssertionError(f"train: iteration {i}: a final value "
                                 "outside trunc & ~term")
        if not bool((traj.final_values[need] != 0).any()):
            raise AssertionError(f"train: iteration {i}: no bootstrap value")
        rows.append(dict(loss=loss, launches=launches,
                         rollout_ms=stats["rollout_ms"],
                         update_ms=stats["update_ms"],
                         host_rate=stats["env_steps_per_s"],
                         resets=int(traj.dones.sum()),
                         bootstraps=int(need.sum())))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_kernel.LAUNCHES = 0
    pol = run_ppo(cfg, MetricLogger(None), on_iteration=on_iteration)
    torch.cuda.synchronize()
    launches = step_kernel.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if len(rows) != iters:
        raise AssertionError(f"train: {len(rows)} iterations ran")
    if all(torch.equal(a.cpu(), b) for a, b in
           zip(pol.state_dict().values(), init.state_dict().values())):
        raise AssertionError("train: the params did not change")
    for i, r in enumerate(rows):
        ms = r["rollout_ms"] + r["update_ms"]
        log(f"train iter {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{r['loss']:.4f}, {ms:.1f} ms/iter = rollout "
            f"{r['rollout_ms']:.1f} + update {r['update_ms']:.1f} ms "
            f"(CUDA events), "
            f"{B * T / ms * 1e3:,.0f} env-steps/s incl. learner; host clock "
            f"{r['host_rate']:,.0f} env-steps/s incl. logging; "
            f"{r['resets']} episode ends, {r['bootstraps']} bootstrapped "
            f"({card})")
    timed = rows[1:]
    ms = sum(r["rollout_ms"] + r["update_ms"] for r in timed) / len(timed)
    roll = sum(r["rollout_ms"] for r in timed) / len(timed)
    log(f"train: {B} envs x T={T}, FCPolicy hidden={pol.hidden}, "
        f"{len(timed)} timed iterations: "
        f"{ms:.1f} ms/iter, {B * T / ms * 1e3:,.0f} env-steps/s incl. "
        f"learner, rollout {roll / ms:.1%} / update {1 - roll / ms:.1%}, "
        f"peak memory {peak_gb:.2f} GiB, {launches} kernel launches in "
        f"{iters} iterations ({card})")
    return launches


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev, card: str):
    from arcle_tpu_torch.envs import random_bbox_actions, random_bbox_rollout
    from arcle_tpu_torch.ops import finish_flood
    from arcle_tpu_torch.ops.step_kernel import (
        cuda_step_deferred, plain_step_deferred)

    env = main_env(dev)
    table = env.table
    bs = env.reset(torch.Generator(device=dev).manual_seed(2), B)
    gen = torch.Generator(device=dev).manual_seed(3)
    acts = [random_bbox_actions(gen, B, table.n_ops, 30, 30, dev)
            for _ in range(8)]
    i = [0]

    def kernel_step():
        cuda_step_deferred(bs.env, acts[i[0] % 8], table)
        i[0] += 1

    def plain_step():
        a = acts[i[0] % 8]
        s, _, _, pend = plain_step_deferred(bs.env, a, table)
        if bool(pend.any()):
            finish_flood(s, a, table, pend)
        i[0] += 1

    for f in (kernel_step, plain_step):
        _event_ms(f, 5)                                      # warm-up
    k_ms = _event_ms(kernel_step, 50)
    p_ms = _event_ms(plain_step, 20)
    k_ms2 = _event_ms(kernel_step, 50)
    p_ms2 = _event_ms(plain_step, 20)
    log(f"timing step B={B}: kernel {k_ms:.4f} / {k_ms2:.4f} ms, plain "
        f"{p_ms:.4f} / {p_ms2:.4f} ms per step (CUDA events; {card})")

    # the same 100-step loop through the kernel and through the plain step
    def plain_env_step(bs_, act):
        env2, reward, term, pend = plain_step_deferred(bs_.env, act, table)
        if bool(pend.any()):
            env2 = finish_flood(env2, act, table, pend)
        env2, reward, term = env._shape_reward_term(env2, reward, term)
        trunc = env2.steps >= env.episode_limit
        return env._auto_reset(env2, bs_, term | trunc), env2, reward, term, \
            trunc

    # ``env`` with its step swapped for the plain one
    plain_env = types.SimpleNamespace(table=table, step=plain_env_step)
    loops = {}
    for name, e in (("kernel", env), ("plain", plain_env),
                    ("kernel2", env), ("plain2", plain_env)):
        steps = MAIN_STEPS if name.startswith("kernel") else 20
        state = [bs]

        def run():
            state[0], _ = random_bbox_rollout(e, state[0], steps, gen)
        _event_ms(run, 1)                                   # warm-up
        loops[name] = _event_ms(run, 1) / steps
    for name, ms in loops.items():
        log(f"timing loop {name}: {ms:.4f} ms/step, "
            f"{B / ms * 1e3:.0f} env-steps/s (CUDA events; {card})")
    return min(k_ms, k_ms2), min(p_ms, p_ms2)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from arcle_tpu_torch.ops import step_kernel
    path, build_s, build_log = step_kernel.build()
    step_kernel.load()
    log(f"build: {build_s:.2f} s -> {path.name}")
    for line in build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"build: {line.strip()}")

    worst = phase_parity(dev)
    phase_engine(dev)
    launches = {"main": phase_main(dev)}
    phase_learner(dev)
    launches["train"] = phase_train(dev, card)
    k_ms, p_ms = phase_timing(dev, card)

    kernels = {"kernels": [{
        "name": "step_kernel", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": worst,
        "ms": k_ms, "plain_ms": p_ms}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
