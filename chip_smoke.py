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
6. timing  -- CUDA-event times of the kernel and of its plain version per
              step at B=4096, and of the 100-step loop through each.

It then prints a JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}.  Any failure raises: the script exits
non-zero and prints no result.  Without CUDA it exits with code 2.
"""

from __future__ import annotations

import dataclasses
import json
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
    launches = phase_main(dev)
    k_ms, p_ms = phase_timing(dev, card)

    kernels = {"kernels": [{
        "name": "step_kernel", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": launches, "max_abs_err": worst,
        "ms": k_ms, "plain_ms": p_ms}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
