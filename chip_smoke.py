#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA engine on one GPU.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # build, then the device work per step

Phases, each printing its numbers on a line of its own:

1. device  -- needs CUDA; prints the card's name and power limit;
2. build   -- compiles csrc/step_kernel.cu with nvcc and loads it; prints
              ptxas's registers, shared memory and spills per
              instantiation, and the env-warps resident per SM;
3. parity  -- the step kernel against its plain PyTorch version (plus the
              flood fix-up) on the same CUDA inputs at B=4096: fuzz steps on
              o2arc_table (with and without crop_at_33), arc_table and
              raw_table at 30x30, o2arc at 5x5, the answer-given suite's
              colour-only table (no Submit op, max_trial=-1) at 5x5 on
              random pairs and on ARC-like tasks, and raw / arc at 12x20,
              5x7 and 16x64 (the instantiation with runtime H, W), and
              the gym adapters' O2ARC without flood ops (25 ops) and
              crop33 at max_trial=127, and bench_cuda's configurations'
              raw at B=256 and arc at B=1024 (max_trial=-1), each after
              the adversarial cases of ``arcle_tpu_torch/testing.py``
              (corridor floods
              seeded at their far end, int8 selections other than 0/1,
              object ops on envs holding an object, reset-on-submit rows);
              every state field, the reward and `terminated` bit-exact;
4. engine  -- BatchedEnv on CUDA (the step kernel, then the engine
              epilogue) against the same engine on the CPU (plain), same
              start, pool and actions, 256 envs x 40 steps across
              auto-resets: carry, obs, the reward's bits, term, trunc and
              the pool counter bit-exact, one epilogue launch a step; the
              o2arc_mlp cells' engine (crop33 table, dense reward,
              augmentation, 8-deep pool, episode_limit 100), 256 envs x
              110 steps, likewise; then the answer-given env (5x5,
              colour-only table, pixel reward, terminate on match,
              pool-less auto-reset with pinned tasks) on CUDA against the
              CPU, 1024 envs x 60 steps with episode_limit=50, half of the
              envs steered to solve, with auto-reset (solved
              terminations, truncations and fresh draws) and without
              (the evaluator's env), all bit-exact; and the epilogue's
              device time per launch (a CUDA graph of 20 dependent
              launches), its bound, host time per call and the plain
              tail's time at B=4096 30x30 (8-deep pool) and B=1024 5x5
              (pool-less);
   gym     -- the Gymnasium surface at B=1, with or without gymnasium:
              the native C++ engine and baker built with g++ (seconds
              logged); the golden-trace set (>= 200 traces, the reference
              fixture's seeds) replayed with ``replay_trace`` and
              ``replay_trace_firstsel`` through ``O2ARCv2Env(backend=
              "torch", device="cuda")`` at 100.00 %, one kernel launch per
              step; Raw, ARC, O2ARCv2, O2ARCNoFill and CustomO2ARCEnv
              (augment, dense) on the card against the native engine and
              the NumPy oracle, 4 episodes x 60 random steps each, every
              observation field, the reward and ``terminated`` bit-exact;
              O2ARCv2 steps per second on the card and native (host clock,
              2,000 steps after a warm-up); where gymnasium imports, one
              ``gym.make("ARCLE-CUDA/O2ARCv2Env-v0")`` episode under
              ``BBoxWrapper`` on the card;
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
6. timing  -- at B=4096 on O2ARCv2 with random bbox actions, for 30x30 and
              5x5: the kernel's device time per launch (a CUDA graph of 20
              dependent launches replayed between CUDA events), its bound
              (the bytes these inputs need over 3.35 TB/s) and share, the
              wrapper's host time per call (host clock, 200 calls), the
              host-inclusive time of a loop of wrapper calls, and the plain
              step; then the 100-step loop through the kernel and through
              the plain step; and the kernel's device time at B=1 (the gym
              adapters), B=2 and B=64 at 30x30, the batches train_gpt's
              E-MAML and PPO launch it at, at B=100 30x30 on train.py's
              crop33 table (its E-MAML), at B=1024 5x5 on the
              colour-only table, where train_answer_given launches it,
              and where bench_cuda's configurations launch it: the raw
              table at B=256 and the arc table with random point actions
              at B=1024, on its 400-task ``write_corpus`` bank;
7. gpt     -- the GPT policy at full width (GPTConfig(): 8 layers, 16
              heads, width 128, T=1837) on the card against the same
              weights on the CPU, B=8 from an O2ARCv2 reset as in
              ``__graft_entry__.entry``, both passes (plain and
              action-conditioned): float32 (TF32 off) within 1e-4 of each
              output's largest magnitude, bf16 within 0.2 of the float32
              output's; one ``evaluate_fn`` gradient at B=4 in float32
              within 1e-3 of each tensor's largest entry; forward ms;
8. emaml   -- train_gpt's E-MAML path through ``run_emaml`` at full width
              (2 tasks x 1 env x 100-step rollouts, 2 micro-batches,
              first-order, chunked, cached chain, KL from the surrogate
              pass, bf16) with inner_steps cut 20 -> 2 and maml_opt_steps
              5 -> 2, one warm-up and one timed meta-iteration: exactly
              rollout_steps x (inner_steps + 1) step-kernel launches per
              meta-iteration, finite meta loss, moved params, the KL
              ladder rule; seconds per meta-iteration with its rollout /
              inner-update / outer split (``unit_times``, CUDA events),
              env-steps/s and peak memory;
9. gpt-ppo -- train_gpt ``--algo ppo --aux-coeff 0.1`` through ``run_ppo``:
              64 envs, T=100, 100 minibatches, vf_coeff 0.5; one warm-up
              and one timed iteration: 100 launches per iteration, finite
              aux losses, ms/iter with the rollout / update split, peak
              memory;
10. answer-given -- the §4.1 policy at full width (4 layers, 4 heads,
              width 128, 62 tokens) on the card against the same weights
              on the CPU, ``color_eq`` and ``sequential``, both passes and
              ``evaluate_fn``: float32 within 1e-4 of each output's largest
              magnitude, bf16 within 0.2; one forward of the bf16-torso
              FCPolicy at full width, card vs CPU, within 0.05 of each
              output's largest magnitude; then train_answer_given's
              defaults through ``train`` (random setting, 16384 tasks,
              1024 envs, T=64, ``color_eq``, categorical head, ``--aux
              all``, potential shaping, 4 epochs x 8 minibatches, bf16),
              one warm-up and two timed iterations: exactly 64 kernel
              launches per iteration, finite losses and aux losses, moved
              params, finished episodes; ms/iter, the rollout / update
              split, env-steps/s including the learner, peak memory; and
              the evaluator on a checkpoint of the run;
11. dt     -- the Decision-Transformer policy at full width (DTConfig(): 4
              layers, 8 heads, width 128) on 64 golden traces of 25 steps
              (75 tokens) from ``dataset_from_traces``, card vs CPU with the
              same weights: the float32 forward (TF32 off) within 1e-4 of
              each output's largest magnitude, ``bc_loss`` within 1e-5
              relative, one gradient within 1e-3 of each tensor's largest
              entry plus 1e-6 of the largest of all; then ``train_bc`` for 50 steps on the card: finite
              losses, the last below 0.9x the first; ms per step and peak
              memory;
12. parallel -- ``init_multihost`` at world size 1 on NCCL and
              ``assert_all_processes_alive``; ``dryrun_multichip(1)`` with
              ``GPTConfig()`` at full depth (3 step-kernel launches
              asserted); the train configuration (4096 envs, T=100, the
              full-width FCPolicy) through the data-parallel update under
              the NCCL group, its params within 1e-5 of the single-process
              ``train_step`` from the same start, then 3 DP iterations of
              100 launches each (ms/iter beside the train phase's);
              ``scaling_report`` at d=1 (NCCL), with the train phase's
              update period, and its 2-process Gloo all-reduce check
              (pred/meas printed, sums and times checked); the group is
              destroyed at the end;
13. emaml-dp -- E-MAML under an NCCL group of one (its own init): (a)
              train.py's default (``parse_config(["--device", "cuda"])``:
              o2arc_crop33, EMAMLConfig() -- 10 tasks x 10 envs x 100
              steps, 5 inner and 5 meta-opt steps, second order -- and the
              full-width FCPolicy) through ``run_emaml(group=WORLD)``, one
              warm-up and one timed meta-iteration: exactly 600 launches
              per meta-iteration at B=100, finite meta loss, moved params,
              the KL ladder rule; s per meta-iteration (host clock), the
              rollout share (CUDA events around ``task_rollout``),
              env-steps/s, peak memory; (b) the fused second-order step
              under the group against the single-process step from the
              same start on the same recorded rollouts: meta loss within
              rtol 1e-4, every param within 1e-5, ladder and bookkeeping
              equal; (c) train_gpt's chunked cached-chain step under the
              group at the ``emaml`` phase's cut, one meta-iteration with
              exactly 300 launches;
14. bench  -- ``bench_cuda.py`` at its defaults through ``bench_cuda.run``:
              3,000 oracle steps (the single-env baseline), the engine at
              4096 x 100 (warm-up, best of 5), the single-env adapter on
              Mini-ARC (30,000 card and 30,000 native steps), raw@256 and
              arc+point@1024 on the 3,200-pair corpus, the reset of 4096
              envs on it, and the train loop (warm-up under the FLOP
              counter, best of 3); every key, positive finite rates,
              shares in [0, 100], ``bind`` as the measured busy share
              gives it and exactly ``steps`` launches per rollout checked;
              its JSON line printed.

It then prints a JSON line describing the kernels, and as its last line
{"ok": true, "device": {...}}.  Any failure raises: the script exits
non-zero and prints no result.  Without CUDA it exits with code 2.
``--profile`` prints the device work per step of the engine loop, the PPO
rollout, the gym adapter on the card (with its host split), the GPT
forward, train_gpt's and train.py's E-MAML rollouts and a task's
second-order meta term of train.py's E-MAML, the answer-given rollout and
minibatch update and the DT policy's behaviour-cloning step, beside their
wall clock (``torch.profiler`` device events) and exits.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import sys
import time
import types

import torch

B = 4096
PARITY_STEPS = 30
MAIN_STEPS = 100
GPT_B, GPT_GRAD_B = 8, 4       # entry()'s batch; the gradient check's
GPT_F32_TOL = 1e-4             # of each output's largest magnitude
GPT_BF16_TOL = 0.2             # of the float32 output's largest magnitude
GPT_GRAD_TOL = 1e-3            # of each gradient tensor's largest entry,
                               # plus 1e-6 of the largest of all (a sum
                               # that cancels to ~0 has no scale of its own)
EMAML_INNER, EMAML_META = 2, 2  # train_gpt's 20 and 5, cut
GPT_BATCHES = (2, 64)          # train_gpt's E-MAML and PPO env batches
AG_B, AG_T = 1024, 64          # train_answer_given's envs and rollout
AG_POLICY_B = 256              # the card-vs-CPU check's batch
GYM_B = 1                      # the gym adapters step one env
GYM_EPISODES, GYM_STEPS = 4, 60   # per env class, card vs native vs oracle
GYM_RATE_STEPS = 2000          # adapter steps timed per backend
MLP_BF16_TOL = 0.05            # of each output's largest magnitude
DT_TRACES, DT_T = 64, 25       # golden traces; steps each (75 tokens)
DT_STEPS = 50                  # train_bc's full-batch Adam steps
DT_F32_TOL = 1e-4              # of each output's largest magnitude
DT_LOSS_RTOL = 1e-5
DT_GRAD_TOL = 1e-3             # as GPT_GRAD_TOL
DRYRUN_T = 3                   # dryrun_multichip's rollout steps
DP_PARAM_TOL = 1e-5            # DP update vs the single-process update
DP_ITERS = 3                   # one warm-up, two timed
EMAML_DP_B = 100               # train.py's E-MAML: 10 tasks x 10 envs
EMAML_DP_LOSS_RTOL = 1e-4      # grouped vs single-process meta loss


def log(*a):
    print(*a, flush=True)


def fuzz_actions(gen, batch, n_ops, H, W, dev):
    """Ops in [-1, n_ops] (clipping included) and selections mixing empty,
    single-pixel, box and sparse random 0/1 masks."""
    from arcle_tpu_torch.core import Action, bbox_selection, point_selection
    I32 = torch.int32
    ops = torch.randint(-1, n_ops + 1, (batch,), generator=gen, device=dev,
                        dtype=I32)
    style = torch.randint(0, 4, (batch,), generator=gen, device=dev)
    r = torch.randint(0, H, (2, batch), generator=gen, device=dev, dtype=I32)
    c = torch.randint(0, W, (2, batch), generator=gen, device=dev, dtype=I32)
    box = bbox_selection(r[0], c[0], r[1], c[1], H, W)
    pix = point_selection(r[0], c[0], H, W)
    sparse = (torch.rand((batch, H, W), generator=gen, device=dev)
              < 0.08).to(torch.int8)
    s = style.view(-1, 1, 1)
    sel = torch.where(s == 1, pix, torch.where(
        s == 2, box, torch.where(s == 3, sparse, torch.zeros_like(box))))
    return Action(selection=sel.contiguous(), operation=ops)


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_step(st, act, table, what: str) -> tuple:
    """The kernel against its plain version (plus the flood fix-up) on one
    step: every state field, the reward and `terminated` bit-exact,
    `pending` all False.  Returns the plain next state and the largest
    absolute difference (0.0)."""
    from arcle_tpu_torch.core import FIELDS
    from arcle_tpu_torch.ops import finish_flood
    from arcle_tpu_torch.ops.step_kernel import (
        cuda_step_deferred, plain_step_deferred)
    ks, kr, kt, kp = cuda_step_deferred(st, act, table)
    ps, pr, pt, pp = plain_step_deferred(st, act, table)
    if bool(pp.any()):
        ps = finish_flood(ps, act, table, pp)
    pairs = [(f, getattr(ks, f), getattr(ps, f)) for f in FIELDS]
    pairs += [("reward", kr, pr), ("terminated", kt, pt),
              ("pending", kp, torch.zeros_like(kp))]
    worst = 0.0
    for field, k, p in pairs:
        if not torch.equal(k, p):
            bad = (k != p).reshape(k.shape[0], -1).any(dim=1).nonzero()
            raise AssertionError(
                f"parity: {what} field {field} differs in {bad.numel()} "
                f"envs, first {bad[:5, 0].tolist()}")
        worst = max(worst, max_abs_diff(k, p))
    return ps, worst


def check_adversarial(st, table, seed: int, what: str) -> float:
    """``testing.step_cases`` on the states ``st``: corridor floods
    seeded at their far end, int8 selections other than 0/1, object ops on
    envs holding an object, reset-on-submit rows."""
    import numpy as np
    from arcle_tpu_torch.core import Action, state_from_numpy, state_to_numpy
    from arcle_tpu_torch.testing import step_cases
    dev = st.grid.device
    worst, names = 0.0, []
    for name, s0, acts in step_cases(state_to_numpy(st), table,
                                     np.random.default_rng(seed)):
        s = state_from_numpy(s0, device=dev)
        for t, (sel, ops) in enumerate(acts):
            act = Action(selection=torch.from_numpy(sel).to(dev),
                         operation=torch.from_numpy(ops).to(dev))
            s, w = check_step(s, act, table, f"{what} {name} step {t}")
            worst = max(worst, w)
        names.append(name)
    torch.cuda.synchronize()
    log(f"parity {what} adversarial: B={st.batch} {', '.join(names)} "
        "bit-exact")
    return worst


def phase_parity(dev) -> float:
    from arcle_tpu_torch.benchmarks import (
        RandomPairLoader, color_table, small_arc_loader)
    from arcle_tpu_torch.benchmarks.bench import CONFIG_ENVS
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table, arc_table, raw_table

    gen = torch.Generator(device=dev)
    # a quarter of the envs re-init on Submit
    ros = torch.arange(B, device=dev) % 4 == 0
    worst = 0.0
    # (name, table, H, W[, loader]): the four tables at 30x30, the 5x5
    # geometry, the answer-given suite's colour-only table (no Submit op,
    # max_trial=-1) at 5x5 on its two task distributions, shapes that
    # take the kernel's instantiation with runtime H, W (non-square, odd,
    # wider than 32 columns), and the no-fill and crop33 tables
    cases = [("o2arc", o2arc_table(max_trial=3), 30, 30),
             ("o2arc_crop33", o2arc_table(max_trial=3, crop_at_33=True),
              30, 30),
             ("arc", arc_table(max_trial=3), 30, 30),
             ("raw", raw_table(max_trial=3), 30, 30),
             ("o2arc_5x5", o2arc_table(max_trial=3), 5, 5),
             ("raw_12x20", raw_table(max_trial=3), 12, 20),
             ("arc_5x7", arc_table(max_trial=3), 5, 7),
             ("arc_16x64", arc_table(max_trial=3), 16, 64),
             ("color_5x5", color_table(10), 5, 5,
              RandomPairLoader(256, 5, 5, 10, seed=3)),
             ("color_5x5_arc", color_table(10), 5, 5,
              small_arc_loader(64, 5, 10, seed=3)),
             # the gym adapters' tables no other path launches: O2ARC
             # without the flood ops (25 ops, Submit at 24), and
             # CustomO2ARCEnv's at the int8 trial counter's limit
             ("o2arc_nofill", o2arc_table(max_trial=3, no_fill=True), 30,
              30),
             ("o2arc_crop33_mt127", o2arc_table(max_trial=127,
                                                crop_at_33=True), 30, 30),
             # bench_cuda's configurations: Raw at 256 envs and ARC at 1024
             # (point actions; the fuzz draws single pixels among its
             # selections), both at max_trial=-1
             (f"raw_B{CONFIG_ENVS[0]}", raw_table(max_trial=-1), 30, 30,
              None, CONFIG_ENVS[0]),
             (f"arc_B{CONFIG_ENVS[1]}", arc_table(max_trial=-1), 30, 30,
              None, CONFIG_ENVS[1])]
    for ti, (name, table, H, W, *given) in enumerate(cases):
        loader = given[0] if given and given[0] else SyntheticLoader(
            16, seed=3, min_size=2, max_size=min(H, W, 12))
        batch = given[1] if len(given) > 1 else B
        env = BatchedEnv(table=table, bank=loader.bank(H, W, device=dev),
                         max_trial=table.max_trial,
                         opts=ResetOptions.make(reset_on_submit=ros[:batch],
                                                device=dev))
        gen.manual_seed(100 + ti)
        st = env.reset(gen, batch).env
        worst = max(worst, check_adversarial(st, table, ti, name))
        steps = PARITY_STEPS if (H, W) == (30, 30) else PARITY_STEPS // 3
        for t in range(steps):
            act = fuzz_actions(gen, batch, table.n_ops, H, W, dev)
            st, w = check_step(st, act, table, f"table {name} step {t}")
            worst = max(worst, w)
        torch.cuda.synchronize()
        log(f"parity {name}: B={batch} {H}x{W} steps={steps} bit-exact")
    return worst


def engine_compare(what: str, env_c, env_g, bs_c, bs_g, steps: int,
                   actions) -> dict:
    """``steps`` lockstep steps of ``env_g`` on the card (the step kernel,
    then the engine epilogue) against ``env_c`` on the CPU (both plain)
    from the same start: carry, obs, the reward's bits, term, trunc and
    the pool counter bit-exact after every step, and one epilogue launch a
    card step.  ``actions(t, state_c)`` gives ``(card action, CPU
    action)``.  Returns the done, terminated and truncated envs and the
    last CPU carry and rewards."""
    from arcle_tpu_torch.core import FIELDS
    from arcle_tpu_torch.ops import step_kernel

    launches = step_kernel.EPILOGUE_LAUNCHES
    done = terms = truncs = 0
    for t in range(steps):
        act_g, act_c = actions(t, bs_c.env)
        bs_g, obs_g, r_g, te_g, tr_g = env_g.step(bs_g, act_g)
        bs_c, obs_c, r_c, te_c, tr_c = env_c.step(bs_c, act_c)
        checks = [("reward bits", r_g.view(torch.int32),
                   r_c.view(torch.int32)),
                  ("term", te_g, te_c), ("trunc", tr_g, tr_c)]
        if bs_c.pool is not None:
            checks.append(("pool.counter", bs_g.pool.counter,
                           bs_c.pool.counter))
        checks += [(f"obs.{f}", getattr(obs_g, f), getattr(obs_c, f))
                   for f in FIELDS]
        checks += [(f"carry.{f}", getattr(bs_g.env, f), getattr(bs_c.env, f))
                   for f in FIELDS]
        for name, g, c in checks:
            if g.dtype != c.dtype or not torch.equal(g.cpu(), c):
                raise AssertionError(f"{what}: step {t} {name} differs")
        done += int((te_c | tr_c).sum())
        terms += int(te_c.sum())
        truncs += int((tr_c & ~te_c).sum())
    launches = step_kernel.EPILOGUE_LAUNCHES - launches
    if launches != steps:
        raise AssertionError(f"{what}: {launches} epilogue launches for "
                             f"{steps} steps")
    return {"done": done, "terms": terms, "truncs": truncs,
            "launches": launches, "bs_c": bs_c, "reward_c": r_c,
            "term_c": te_c}


EPILOGUES: dict = {}  # engine epilogue launches by main path, as counted


def zero_launches() -> None:
    """Zero the step kernel's and the engine epilogue's launch counters."""
    from arcle_tpu_torch.ops import step_kernel
    step_kernel.LAUNCHES = step_kernel.EPILOGUE_LAUNCHES = 0


def count_epilogues(path: str, steps: int) -> int:
    """The engine epilogue's launches since :func:`zero_launches`, which
    must equal the ``steps`` BatchedEnv took on the card (one epilogue a
    step); kept under ``path`` for the kernels line."""
    from arcle_tpu_torch.ops import step_kernel
    got = step_kernel.EPILOGUE_LAUNCHES
    if got != steps:
        raise AssertionError(f"{path}: {got} engine epilogue launches for "
                             f"{steps} BatchedEnv steps")
    EPILOGUES[path] = EPILOGUES.get(path, 0) + got
    return got


def carry_to(bs, dev):
    """A carry on ``dev`` (the card or the CPU), with a fresh generator
    there."""
    from arcle_tpu_torch.envs.core import BatchedState
    to_dev = lambda s: type(s)(**{f.name: getattr(s, f.name).to(dev)
                                  for f in dataclasses.fields(s)})
    return BatchedState(env=to_dev(bs.env),
                        generator=torch.Generator(device=dev),
                        pool=None if bs.pool is None else to_dev(bs.pool))


def mlp_cell_env(bank):
    """The ``o2arc_mlp`` cells' engine: train.py's crop33 table at
    max_trial 127, dense reward, augmentation, an 8-deep pool and
    episode_limit 100."""
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.ops import o2arc_table
    return BatchedEnv(table=o2arc_table(max_trial=127, crop_at_33=True),
                      bank=bank, max_trial=127, episode_limit=100,
                      auto_reset=True, dense_reward=True, augment=True,
                      reset_pool=8)


def phase_engine(dev) -> dict:
    """BatchedEnv on CUDA (step kernel and engine epilogue) against
    BatchedEnv on the CPU (plain), then the epilogue's timings."""
    from arcle_tpu_torch.benchmarks.roofline import card_line
    from arcle_tpu_torch.envs import BatchedEnv, random_bbox_actions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table

    def bbox(gen, n, n_ops):
        def actions(t, st):
            act = random_bbox_actions(gen, n, n_ops, 30, 30, dev)
            return act, type(act)(selection=act.selection.cpu(),
                                  operation=act.operation.cpu())
        return actions

    n, steps = 256, 40
    bank = SyntheticLoader(16, seed=3).bank(device="cpu")
    mk = lambda b: BatchedEnv(table=o2arc_table(max_trial=-1), bank=b,
                              max_trial=-1, episode_limit=12,
                              auto_reset=True, reset_pool=3)
    env_c, env_g = mk(bank), mk(bank.to(dev))
    bs_c = env_c.reset(torch.Generator().manual_seed(7), n)
    out = engine_compare("engine", env_c, env_g, bs_c, carry_to(bs_c, dev),
                         steps,
                         bbox(torch.Generator(device=dev).manual_seed(8), n,
                              35))
    resets = int(out["bs_c"].pool.counter.sum())
    if resets < n:
        raise AssertionError(f"engine: only {resets} auto-resets")
    log(f"engine: BatchedEnv cuda vs cpu, {n} envs x {steps} steps, "
        f"{resets} auto-resets, {out['launches']} epilogue launches, "
        "bit-exact")

    # the o2arc_mlp cells' engine: dense reward, augmented 8-deep pool
    steps = 110
    bank = SyntheticLoader(32, seed=7).bank(device="cpu")
    env_c, env_g = mlp_cell_env(bank), mlp_cell_env(bank.to(dev))
    bs_c = env_c.reset(torch.Generator().manual_seed(9), n)
    out = engine_compare("engine o2arc_mlp", env_c, env_g, bs_c,
                         carry_to(bs_c, dev), steps,
                         bbox(torch.Generator(device=dev).manual_seed(10), n,
                              env_c.table.n_ops))
    if out["truncs"] < n // 2:
        raise AssertionError(f"engine o2arc_mlp: only {out['truncs']} "
                             "truncations")
    log(f"engine o2arc_mlp: crop33 table, dense reward, augment, pool 8, "
        f"episode_limit 100, cuda vs cpu, {n} envs x {steps} steps, "
        f"{out['done']} auto-resets ({out['truncs']} truncated), "
        f"{out['launches']} epilogue launches, reward bits, term, trunc, "
        "obs, carry, counter bit-exact")

    # the same engine at the main path's B=4096: the card steps alone to
    # step 94 of the first episodes, then card and CPU go on in lockstep
    # across the truncations at step 100 and the resets from the pool
    n, lead, steps = B, 94, 12
    env_g = mlp_cell_env(bank.to(dev))
    bs_g = env_g.reset(torch.Generator(device=dev).manual_seed(11), n)
    act_gen = torch.Generator(device=dev).manual_seed(12)
    for _ in range(lead):
        bs_g = env_g.step(bs_g, random_bbox_actions(
            act_gen, n, env_g.table.n_ops, 30, 30, dev))[0]
    out = engine_compare(f"engine o2arc_mlp B={n}", env_c, env_g,
                         carry_to(bs_g, torch.device("cpu")), bs_g, steps,
                         bbox(act_gen, n, env_c.table.n_ops))
    if out["truncs"] < n // 2:
        raise AssertionError(f"engine o2arc_mlp B={n}: only {out['truncs']} "
                             "truncations")
    log(f"engine o2arc_mlp B={n}: {lead} steps on the card alone, then "
        f"cuda vs cpu, {n} envs x {steps} steps, {out['done']} auto-resets "
        f"({out['truncs']} truncated), {out['launches']} epilogue launches, "
        "reward bits, term, trunc, obs, carry, counter bit-exact")
    engine_answer_given(dev, auto_reset=True)
    engine_answer_given(dev, auto_reset=False)
    card = card_line()
    return {"30x30": time_epilogue(dev, card, "o2arc_mlp"),
            "5x5": time_epilogue(dev, card, "answer_given")}


def steering_actions(st, helpful, gen):
    """Bbox actions ``[B, 5]`` for answer-given states on the CPU: the
    ``helpful`` envs paint (9 steps in 10) their first wrong cell in the
    answer's colour, so their episodes end solved; every other action is a
    random box and colour."""
    n, H, W = st.grid.shape
    rnd = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen)
    wrong = (st.grid != st.answer).reshape(n, -1)
    cell = wrong.to(torch.int8).argmax(-1)
    r, c = cell // W, cell % W
    colour = st.answer.reshape(n, -1).gather(1, cell[:, None])[:, 0].long()
    fix = torch.stack([r, c, r, c, colour], 1)
    box = torch.cat([rnd(H, n, 1), rnd(W, n, 1), rnd(H, n, 1), rnd(W, n, 1),
                     rnd(10, n, 1)], 1)
    steer = helpful & wrong.any(-1) & (torch.rand(n, generator=gen) < 0.9)
    return torch.where(steer[:, None], fix, box).to(torch.int32)


def engine_answer_given(dev, auto_reset: bool = True):
    """The answer-given env on CUDA (kernel) against the same env on the
    CPU (plain), at its B=1024: pinned tasks, so the pool-less auto-reset
    draws the same fresh episodes; the same actions.  Without auto-reset
    (the evaluator's env), solved envs stay terminated."""
    from arcle_tpu_torch.benchmarks import answer_given_env
    from arcle_tpu_torch.envs import ResetOptions
    from arcle_tpu_torch.training.rollout import decode_bbox_actions

    n, steps, limit = AG_B, 60, 50
    env_c = answer_given_env(n_tasks=4096, seed=5, episode_limit=limit,
                             device="cpu")
    pin = ResetOptions.make(prob_index=torch.arange(n) * 4, subprob_index=0,
                            device="cpu")
    env_c = dataclasses.replace(env_c, opts=pin, auto_reset=auto_reset)
    env_g = dataclasses.replace(env_c, bank=env_c.bank.to(dev),
                                opts=pin.to(dev))
    bs_c = env_c.reset(torch.Generator().manual_seed(7), n)
    gen = torch.Generator().manual_seed(8)
    helpful = torch.arange(n) % 2 == 0

    def actions(t, st):
        acts = steering_actions(st, helpful, gen)
        return decode_bbox_actions(acts.to(dev), 5, 5), \
            decode_bbox_actions(acts, 5, 5)

    what = f"engine answer-given{'' if auto_reset else ' (no auto-reset)'}"
    out = engine_compare(what, env_c, env_g, bs_c, carry_to(bs_c, dev), steps,
                         actions)
    r_c, te_c = out["reward_c"], out["term_c"]
    if (auto_reset and not torch.equal(r_c == 0, te_c)) or \
            float(r_c.min()) < -1.0 or float(r_c.max()) > 0.0:
        raise AssertionError(f"{what}: the pixel reward is not in [-1, 0] "
                             "with 0 at a solve")
    solved, truncated = out["terms"], out["truncs"]
    if auto_reset and (solved < n // 2 or truncated < n // 4):
        raise AssertionError(f"{what}: {solved} solved and {truncated} "
                             "truncated episodes")
    if not auto_reset and int(te_c.sum()) < n // 4:
        raise AssertionError(f"{what}: only {int(te_c.sum())} envs "
                             "terminated")
    log(f"{what}: answer_given_env cuda vs cpu, {n} envs x {steps} steps, "
        f"episode_limit={limit}, colour-only 5x5 table, {solved} solved "
        f"terminations, {truncated} truncations, "
        f"{'every one auto-reset' if auto_reset else 'none reset'}, "
        f"{out['launches']} epilogue launches, pixel reward bits, term, "
        "trunc, obs, carry bit-exact")


def epilogue_bytes(env2, done, shaped: bool) -> float:
    """The bytes one epilogue launch must move: every env writes its carried
    state (8 grids and 33 bytes of scalars) and 10 bytes of counter,
    reward, term and trunc; a live env reads its post-step state and 9
    bytes of reward, term and counter; a done env reads its scalars, its
    fresh grid, answer and dims, and its grid and answer for the counts
    where the reward is shaped or a match ends it."""
    B, H, W = env2.grid.shape
    P = H * W
    n_done = int(done.sum())
    write = B * (8 * P + 33 + 10)
    read = (B - n_done) * (8 * P + 33 + 9) + \
        n_done * (33 + 9 + 2 * P + 4 + (2 * P if shaped else 0))
    return float(read + write)


def time_epilogue(dev, card: str, which: str) -> dict:
    """The engine epilogue where the main paths launch it: ``o2arc_mlp``
    (B=4096 30x30, 8-deep pool) or ``answer_given`` (B=1024 5x5,
    pool-less, fresh rows drawn once here).  Device time per launch (a CUDA
    graph of 20 dependent launches replayed between CUDA events, as the
    step kernel's), its bound, the wrapper's host time per call and the
    plain tail's time per step on the card (CUDA events)."""
    from arcle_tpu_torch.benchmarks import answer_given_env
    from arcle_tpu_torch.envs import random_bbox_actions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import step_kernel

    if which == "o2arc_mlp":
        env = mlp_cell_env(SyntheticLoader(32, seed=7).bank(device=dev))
        batch, side = B, 30
    else:
        env, batch, side = answer_given_env(n_tasks=4096, seed=3,
                                            device=dev), AG_B, 5
    bs = env.reset(torch.Generator(device=dev).manual_seed(2), batch)
    gen = torch.Generator(device=dev).manual_seed(3)
    for _ in range(3):                     # a state some steps in
        bs = env.step(bs, random_bbox_actions(gen, batch, env.table.n_ops,
                                              side, side, dev))[0]
    act = random_bbox_actions(gen, batch, env.table.n_ops, side, side, dev)
    env2, reward, term = step_kernel.complete_step(bs.env, act, env.table)
    ros = env.reset_on_submit_i8
    if bs.pool is not None:
        p = bs.pool
        fresh, k = (p.grid, p.dim, p.answer, p.answer_dim, p.counter,
                    ros), p.k
    else:
        fresh, k = env.draw_fresh(torch.Generator(device=dev).manual_seed(4),
                                  batch) + (None, ros), 0
    lib = step_kernel.load()
    shaped = env.dense_reward or env.pixel_reward or env.terminate_on_match

    def epilogue(s, a, t):                 # chained: the carry feeds the next
        stream = torch.cuda.current_stream(dev).cuda_stream
        return step_kernel._epilogue(lib, stream, env, bs, s, s.last_reward,
                                     term, fresh, k)[0].env,

    done = term | (env2.steps >= env.episode_limit)
    nbytes = epilogue_bytes(env2, done, shaped)
    bound_ms = nbytes / hbm_bytes_per_s() * 1e3
    dev_ms = [graph_device_ms(epilogue, env2, [None], None)
              for _ in range(2)]
    host = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            step_kernel.step_epilogue(env, bs, env2, reward, term)
        host.append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    gen_p = torch.Generator(device=dev)

    def plain():
        gen_p.manual_seed(5)
        env.plain_epilogue(type(bs)(env=env2, generator=gen_p, pool=bs.pool),
                           env2, reward, term)
    _event_ms(plain, 3)                                   # warm-up
    plain_ms = [_event_ms(plain, 20) for _ in range(2)]
    out = dict(device_ms=min(dev_ms), host_us=min(host),
               plain_ms=min(plain_ms), bound_ms=bound_ms,
               bytes_per_launch=nbytes, roofline_share=bound_ms / min(dev_ms),
               done=int(done.sum()))
    log(f"timing epilogue B={batch} {side}x{side} {which} "
        f"({'pool' if k else 'pool-less'}, {out['done']} done): device "
        f"{dev_ms[0] * 1e3:.2f} / {dev_ms[1] * 1e3:.2f} us per launch (CUDA "
        f"graph of 20 dependent launches, CUDA events); bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.3f} MB per launch at "
        f"{hbm_bytes_per_s() / 1e12:.2f} TB/s), {out['roofline_share']:.1%} "
        f"of it; wrapper host {host[0]:.1f} / {host[1]:.1f} us per call "
        f"(host clock, 200 calls); plain tail {plain_ms[0]:.4f} / "
        f"{plain_ms[1]:.4f} ms per step (CUDA events) ({card})")
    return out


def gym_random_action(rng, n_ops: int, side: int = 30) -> dict:
    """An empty, one-pixel or box selection and a uniform op."""
    import numpy as np
    kind = int(rng.integers(0, 3))
    sel = np.zeros((side, side), np.int8)
    if kind == 1:
        sel[rng.integers(0, side), rng.integers(0, side)] = 1
    elif kind == 2:
        x1, x2 = sorted(rng.integers(0, side, 2).tolist())
        y1, y2 = sorted(rng.integers(0, side, 2).tolist())
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    return {"selection": sel, "operation": int(rng.integers(0, n_ops))}


def gym_compare(what: str, got: dict, want: dict) -> None:
    """Every field of an observation dict (``want``'s keys) bit-exact."""
    import numpy as np
    for k, v in want.items():
        if k == "object_states":
            gym_compare(what, got[k], v)
            continue
        g, w = np.asarray(got[k]), np.asarray(v)
        if g.dtype != w.dtype or g.shape != w.shape or \
                not np.array_equal(g, w):
            raise AssertionError(f"gym: {what}: field {k} differs")


def gym_replay(env, traces, infos) -> tuple:
    """The golden set through ``env`` with both harnesses; returns the
    steps taken and the kernel launches, which must be equal."""
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.validation import (
        ReplayReport, replay_trace, replay_trace_firstsel)
    steps = 0
    step_kernel.LAUNCHES = 0
    for name, replay in (("replay_trace", replay_trace),
                         ("replay_trace_firstsel", replay_trace_firstsel)):
        report = ReplayReport()
        for idx, (trace, (ti, sub)) in enumerate(zip(traces, infos)):
            replay(env, trace, {"adaptation": False, "prob_index": ti,
                                "subprob_index": sub}, idx, report)
            steps += env.action_steps
        if report.tested != len(traces) or report.pass_rate != 100.0:
            raise AssertionError(f"gym: golden {name}: {report.summary()}")
        log(f"gym golden {name}: {len(traces)} traces through "
            f"O2ARCv2Env(backend='torch', device='cuda'): {report.summary()}")
    launches = step_kernel.LAUNCHES
    if launches != steps:
        raise AssertionError(f"gym: {launches} kernel launches for {steps} "
                             "replayed steps")
    return steps, launches


def gym_three_way(dev, cls, family: str, kw: dict) -> int:
    """``cls`` on the card against the same class on the native engine and
    against the NumPy oracle on the adapter's task: GYM_EPISODES episodes
    of GYM_STEPS random steps; the last episode re-initialises on Submit.
    Returns the card's steps."""
    import numpy as np
    from arcle_tpu_torch.envs import CustomO2ARCEnv
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.oracle import OracleEnv

    loader = SyntheticLoader(8, seed=5)
    card = cls(data_loader=loader, backend="torch", device=dev, **kw)
    host = cls(data_loader=loader, backend="native", **kw)
    custom = isinstance(card, CustomO2ARCEnv)
    rng = np.random.default_rng(17)
    launches0, steps = step_kernel.LAUNCHES, 0
    for ep in range(GYM_EPISODES):
        ros = ep == GYM_EPISODES - 1
        outs = []
        for env in (card, host):
            if custom:
                env.set_task(ep)
                outs.append(env.reset(seed=ep))
            else:
                outs.append(env.reset(seed=ep, options={
                    "prob_index": ep, "subprob_index": 0,
                    "reset_on_submit": ros}))
        what = f"{cls.__name__} episode {ep}"
        gym_compare(f"{what} reset", outs[0][0], outs[1][0])
        orc = OracleEnv(family, card.H, card.W, card.max_trial)
        orc.reset(card.input_, card.answer, reset_on_submit=ros and not custom)
        gym_compare(f"{what} reset vs oracle", orc.state, outs[0][0])
        for t in range(GYM_STEPS):
            act = gym_random_action(rng, len(card.operations), card.H)
            o_c, r_c, te_c, _, i_c = card.step(act)
            o_n, r_n, te_n, _, i_n = host.step(act)
            st, r_o, te_o = orc.step(act["selection"], act["operation"])
            if custom:
                r_o = card._dense_reward(st, r_o)
            at = f"{what} step {t} op {act['operation']}"
            if not (r_c == r_n == r_o and te_c == te_n == te_o):
                raise AssertionError(f"gym: {at}: reward {r_c} / {r_n} / "
                                     f"{r_o}, terminated {te_c} / {te_n} / "
                                     f"{te_o} (card / native / oracle)")
            gym_compare(f"{at} card vs native", o_c, o_n)
            gym_compare(f"{at} card vs oracle", o_c,
                        {k: st[k] for k in o_c})
            if not (i_c["steps"] == i_n["steps"] == st["_steps"]) or \
                    i_c.get("submit_count") != i_n.get("submit_count"):
                raise AssertionError(f"gym: {at}: info differs")
            steps += 1
    if step_kernel.LAUNCHES - launches0 != steps:
        raise AssertionError(f"gym: {cls.__name__}: "
                             f"{step_kernel.LAUNCHES - launches0} launches "
                             f"for {steps} steps")
    return steps


def gym_rate(dev, backend: str) -> float:
    """O2ARCv2 adapter steps per second (host clock) over GYM_RATE_STEPS
    random steps after a warm-up of 100."""
    import numpy as np
    from arcle_tpu_torch.envs import O2ARCv2Env
    from arcle_tpu_torch.loaders import SyntheticLoader
    env = O2ARCv2Env(data_loader=SyntheticLoader(8, seed=5), backend=backend,
                     device=dev)
    rng = np.random.default_rng(3)
    acts = [gym_random_action(rng, 35) for _ in range(GYM_RATE_STEPS)]
    env.reset(seed=0, options={"prob_index": 0, "subprob_index": 0})
    for a in acts[:100]:
        env.step(a)
    t0 = time.perf_counter()
    for a in acts:
        env.step(a)
    return GYM_RATE_STEPS / (time.perf_counter() - t0)


def phase_gym(dev, card: str) -> dict:
    """The Gymnasium surface on the card at B=1 (see the module)."""
    from arcle_tpu_torch import native
    from arcle_tpu_torch.envs import (
        ARCEnv, CustomO2ARCEnv, O2ARCNoFillEnv, O2ARCv2Env, RawARCEnv, gym)
    from arcle_tpu_torch.loaders import ListLoader
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.validation import (
        generate_adversarial_traces, generate_golden_traces)

    built = {name: native.build(name) for name in ("engine", "bake")}
    if not (native.available() and native.engine_available()):
        raise AssertionError(f"gym: the native libraries do not load: "
                             f"{native._failed}")
    log("gym build: " + ", ".join(f"{p.name} {sec:.2f} s" for p, sec in
                                  built.values()) + " (g++ -O2)")
    log(f"gym: gymnasium {'present, ' + gym.__version__ if gym else 'absent'}"
        " on this machine")

    tasks, traces, infos = generate_golden_traces(n_traces=130, seed=3,
                                                  n_steps=25)
    atasks, atraces, ainfos = generate_adversarial_traces(seed=9)
    n = len(tasks)
    tasks, traces = list(tasks) + list(atasks), traces + atraces
    infos = infos + [(ti + n, sub) for ti, sub in ainfos]
    if len(traces) < 200:
        raise AssertionError(f"gym: only {len(traces)} golden traces")
    env = O2ARCv2Env(data_loader=ListLoader(tasks), max_trial=-1,
                     backend="torch", device=dev)
    golden_steps, golden_launches = gym_replay(env, traces, infos)

    step_kernel.LAUNCHES = 0
    classes = ((RawARCEnv, "raw", {}), (ARCEnv, "arc", {}),
               (O2ARCv2Env, "o2arc", {"max_trial": 3}),
               (O2ARCNoFillEnv, "o2arc_nofill", {}),
               (CustomO2ARCEnv, "o2arc_crop33",
                {"max_trial": 7, "augment": True, "dense": True}))
    compared = {cls.__name__: gym_three_way(dev, cls, fam, kw)
                for cls, fam, kw in classes}
    log(f"gym: card vs native vs oracle, {GYM_EPISODES} episodes x "
        f"{GYM_STEPS} random steps (empty, pixel, bbox) per class: " +
        ", ".join(f"{k} {v} steps" for k, v in compared.items()) +
        "; obs, reward, terminated, info bit-exact")

    rates = {}
    for name, backend in (("card", "torch"), ("native", "native"),
                          ("card2", "torch"), ("native2", "native")):
        rates[name] = gym_rate(dev, backend)
    log(f"timing gym O2ARCv2 adapter: card {rates['card']:,.0f} / "
        f"{rates['card2']:,.0f} steps/s, native {rates['native']:,.0f} / "
        f"{rates['native2']:,.0f} steps/s ({GYM_RATE_STEPS} steps after a "
        f"warm-up, host clock; {card})")

    episode = 0
    if gym is not None:
        from arcle_tpu_torch.loaders import SyntheticLoader
        from arcle_tpu_torch.wrappers import BBoxWrapper
        env = BBoxWrapper(gym.make("ARCLE-CUDA/O2ARCv2Env-v0",
                                   data_loader=SyntheticLoader(8, seed=5),
                                   device=dev, max_trial=3,
                                   max_episode_steps=100))
        env.action_space.seed(0)
        before = step_kernel.LAUNCHES
        env.reset(seed=0, options={"prob_index": 0})
        done = False
        while not done:
            obs, r, term, trunc, _ = env.step(env.action_space.sample())
            done = term or trunc
            episode += 1
        if step_kernel.LAUNCHES - before != episode or \
                not env.observation_space.contains(obs):
            raise AssertionError("gym: the gym.make episode")
        log(f"gym: gym.make('ARCLE-CUDA/O2ARCv2Env-v0') under BBoxWrapper, "
            f"one episode of {episode} steps on the card "
            f"({'terminated' if term else 'truncated'})")
    return dict(launches=golden_launches + step_kernel.LAUNCHES,
                golden_steps=golden_steps, rates=rates,
                compared=sum(compared.values()), episode=episode)


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

    zero_launches()
    t0 = time.perf_counter()
    bs, chk = random_bbox_rollout(env, bs, MAIN_STEPS, act_gen)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = step_kernel.LAUNCHES

    if launches != MAIN_STEPS:
        raise AssertionError(f"main: {launches} kernel launches for "
                             f"{MAIN_STEPS} steps")
    epilogues = count_epilogues("main", MAIN_STEPS)
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
        f"epilogue launches={epilogues}, "
        f"auto-resets={int(resets.sum())} (every env), checksum={int(chk)}, "
        f"warm-up {warm_s:.3f} s, run {run_s:.3f} s (host clock)")
    return launches


def phase_learner(dev):
    """The learner on the card against the learner on the CPU, full width,
    on one batch of 2048 rows from a short CUDA rollout."""
    from arcle_tpu_torch.benchmarks.bench import train_config
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
    from arcle_tpu_torch.benchmarks.bench import train_config
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
    zero_launches()
    pol = run_ppo(cfg, MetricLogger(None), on_iteration=on_iteration)
    torch.cuda.synchronize()
    launches = step_kernel.LAUNCHES
    count_epilogues("train", launches)
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
        f"peak memory {peak_gb:.2f} GiB, {launches} kernel launches and as "
        f"many epilogue launches in {iters} iterations ({card})")
    update = sum(r["update_ms"] for r in timed) / len(timed)
    return {"launches": launches, "ms": ms, "update_ms": update}


def gpt_state(n: int):
    """``__graft_entry__.entry``'s batch: ``n`` O2ARCv2 envs reset on
    SyntheticLoader(4, seed=0), on the CPU."""
    from arcle_tpu_torch.envs import BatchedEnv
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import o2arc_table
    env = BatchedEnv(table=o2arc_table(max_trial=3),
                     bank=SyntheticLoader(4, seed=0).bank(device="cpu"),
                     max_trial=3, episode_limit=10, auto_reset=True)
    return env.reset(torch.Generator().manual_seed(0), n).env


def phase_gpt(dev, card: str) -> dict:
    """The full-width GPT on the card against the CPU, same weights, both
    passes, float32 and bf16; one evaluate_fn gradient; forward ms."""
    from arcle_tpu_torch.models import GPTConfig, GPTPolicy
    from arcle_tpu_torch.training.agents import gpt_agent
    from arcle_tpu_torch.wrappers import full_flatten_obs

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("gpt: float32 matmuls are not full float32")
    s = gpt_state(GPT_B)
    names = ("grid", "grid_dim", "input", "input_dim", "trials_remain",
             "active")
    args_c = [getattr(s, n) for n in names]
    args_g = [a.to(dev) for a in args_c]
    gen = torch.Generator().manual_seed(1)
    passes = {"plain": {}, "conditioned": dict(
        operation=torch.randint(0, 35, (GPT_B,), generator=gen),
        bbox=torch.rand((GPT_B, 4), generator=gen))}
    ref, worst, ms = {}, {}, {}
    for dname, dtype in (("float32", torch.float32),
                         ("bf16", torch.bfloat16)):
        pol_c = GPTPolicy(GPTConfig(dtype=dtype),
                          generator=torch.Generator().manual_seed(0))
        pol_g = copy.deepcopy(pol_c).to(dev)
        for pname, kw in passes.items():
            kw_g = {k: v.to(dev) for k, v in kw.items()}
            with torch.no_grad():
                out_c = pol_c(*args_c, **kw)
                out_g = pol_g(*args_g, **kw_g)
                torch.cuda.synchronize()
                ms[f"{dname} {pname}"] = min(_event_ms(
                    lambda: pol_g(*args_g, **kw_g), 10) for _ in range(2))
            if dname == "float32":
                ref[pname] = out_c
            tol = GPT_F32_TOL if dname == "float32" else GPT_BF16_TOL
            for k, c in out_c.items():
                g = out_g[k].float().cpu()
                if tuple(g.shape) != tuple(c.shape) or \
                        not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"gpt: {dname} {pname} {k} shape "
                                         f"{tuple(g.shape)} or not finite")
                scale = float(ref[pname][k].abs().max())
                err = max_abs_diff(g, c.float())
                if not err <= tol * scale:
                    raise AssertionError(
                        f"gpt: {dname} {pname} {k}: card vs cpu {err:.3e} "
                        f"> {tol} x {scale:.3e}")
                worst[dname] = max(worst.get(dname, 0.0), err / scale)

    # one evaluate_fn gradient in float32 (through the recomputed blocks)
    pol_c = GPTPolicy(GPTConfig(dtype=torch.float32),
                      generator=torch.Generator().manual_seed(0))
    pol_g = copy.deepcopy(pol_c).to(dev)
    agent = gpt_agent(pol_c)
    obs = full_flatten_obs(s)[:GPT_GRAD_B]
    acts = torch.cat([torch.randint(0, 30, (GPT_GRAD_B, 4), generator=gen),
                      torch.randint(0, 35, (GPT_GRAD_B, 1), generator=gen)],
                     1).to(torch.int32)
    grads = {}
    for name, pol, d in (("cuda", pol_g, dev), ("cpu", pol_c, "cpu")):
        lp, value, ent = agent.evaluate_fn(pol, obs.to(d), acts.to(d))
        (lp.sum() + value.sum() + ent.sum()).backward()
        grads[name] = {k: p.grad.cpu() for k, p in pol.named_parameters()
                       if p.grad is not None}
    if set(grads["cuda"]) != set(grads["cpu"]) or not grads["cpu"]:
        raise AssertionError("gpt: gradients reach other parameters")
    worst_grad = 0.0
    top = max(float(c.abs().max()) for c in grads["cpu"].values())
    for k, c in grads["cpu"].items():
        scale = float(c.abs().max())
        err = max_abs_diff(grads["cuda"][k], c)
        if not err <= GPT_GRAD_TOL * scale + 1e-6 * top:
            raise AssertionError(f"gpt: grad {k} card vs cpu {err:.3e} > "
                                 f"{GPT_GRAD_TOL} x {scale:.3e} + 1e-6 x "
                                 f"{top:.3e}")
        worst_grad = max(worst_grad, err / (scale + 1e-3 * top))
    c = pol_c.cfg
    log(f"gpt: GPTConfig() {c.n_layer}L/{c.n_head}H/{c.n_embd}E "
        f"T={c.num_tokens}, B={GPT_B}, card vs cpu, both "
        f"passes: float32 worst {worst['float32']:.3e} of the output's "
        f"scale (tol {GPT_F32_TOL}), bf16 worst {worst['bf16']:.3e} (tol "
        f"{GPT_BF16_TOL}); evaluate_fn gradient B={GPT_GRAD_B} float32 "
        f"worst {worst_grad:.3e} of each tensor's scale (tol "
        f"{GPT_GRAD_TOL}, + 1e-6 of the largest gradient {top:.3e}), "
        f"{len(grads['cpu'])} tensors; TF32 off")
    log(f"timing gpt forward B={GPT_B}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items())
        + f" (CUDA events, 10 calls; {card})")
    return ms


def check_kl_ladder(what: str, e, before: torch.Tensor, kls: torch.Tensor,
                    after: torch.Tensor) -> None:
    """The KL-coefficient ladder rule (emaml_policy.py:284-299): x1.5
    above twice the target, x0.5 below half of it."""
    want = torch.where(kls > 2.0 * e.kl_target, before * 1.5, before)
    want = torch.where(kls < 0.5 * e.kl_target, want * 0.5, want)
    if not torch.equal(after.cpu(), want):
        raise AssertionError(f"{what}: kl_coeffs {after} do not follow the "
                             f"ladder from {before} at {kls}")


def phase_emaml(dev, card: str) -> dict:
    """train_gpt's E-MAML envelope through ``run_emaml``, inner and meta
    steps cut; one warm-up and one timed meta-iteration."""
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.training import train_gpt
    from arcle_tpu_torch.training.train import build_agent, run_emaml
    from arcle_tpu_torch.utils import MetricLogger

    cfg, _ = train_gpt.parse_config([
        "--device", "cuda", "--iterations", "2",
        "--inner-steps", str(EMAML_INNER), "--meta-steps", str(EMAML_META)])
    cfg = dataclasses.replace(cfg, checkpoint_every=0)
    e = cfg.emaml
    per_iter = e.rollout_steps * (e.inner_steps + 1)
    env_steps = e.n_tasks * e.envs_per_task * per_iter
    init = build_agent(cfg).init_fn(torch.Generator().manual_seed(cfg.seed))
    rows = []
    kc = [torch.full((e.n_tasks, e.inner_steps), 0.0005)]
    t_prev = [0.0]

    def on_iteration(i, st, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        launches = step_kernel.LAUNCHES - sum(r["launches"] for r in rows)
        if launches != per_iter:
            raise AssertionError(f"emaml: meta-iteration {i} launched the "
                                 f"step kernel {launches} times, not "
                                 f"{per_iter}")
        loss = float(m["meta_loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"emaml: meta-iteration {i} loss {loss}")
        kls = m["inner_kls"].cpu()
        check_kl_ladder("emaml", e, kc[0], kls, st.kl_coeffs)
        kc[0] = st.kl_coeffs.cpu()
        ut = m["unit_times"]
        part = lambda *names: sum(ut[n]["s"] for n in names if n in ut)
        rows.append(dict(loss=loss, launches=launches, s=now - t_prev[0],
                         rollout=part("rollout", "rollout[det]"),
                         inner=part("update+chain", "update"),
                         outer=part("outer", "shift", "chain"),
                         kls=kls.tolist(), kc=kc[0].tolist(),
                         post=float(m["post_eprew_mean"])))
        t_prev[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t_prev[0] = time.perf_counter()
    pol = run_emaml(cfg, MetricLogger(None), on_iteration=on_iteration,
                    profile=True)
    torch.cuda.synchronize()
    launches = step_kernel.LAUNCHES
    count_epilogues("emaml", launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if len(rows) != cfg.total_iterations:
        raise AssertionError(f"emaml: {len(rows)} meta-iterations ran")
    if all(torch.equal(a.cpu(), b) for a, b in
           zip(pol.state_dict().values(), init.state_dict().values())):
        raise AssertionError("emaml: the params did not change")
    for i, r in enumerate(rows):
        split = r["rollout"] + r["inner"] + r["outer"]
        tag = " (warm-up, set-up included)" if i == 0 else ""
        log(f"emaml meta-iteration {i}{tag}: "
            f"{r['s']:.3f} s (host clock), units {split:.3f} s = rollout "
            f"{r['rollout']:.3f} + inner update {r['inner']:.3f} + outer "
            f"{r['outer']:.3f} s (CUDA events); {env_steps / r['s']:,.1f} "
            f"env-steps/s; meta loss {r['loss']:.5f}, post eprew "
            f"{r['post']:.3f}, inner KLs {r['kls']}, kl_coeffs {r['kc']}; "
            f"{r['launches']} kernel launches at B="
            f"{e.n_tasks * e.envs_per_task} ({card})")
    g = cfg.gpt
    log(f"emaml: train_gpt envelope, GPT {g.n_layer}L/{g.n_head}H/"
        f"{g.n_embd}E {g.dtype}, {e.n_tasks} "
        f"tasks x {e.envs_per_task} env x {e.rollout_steps} steps, n_micro "
        f"{e.n_micro}, inner_steps cut 20 -> {e.inner_steps}, "
        f"maml_opt_steps cut 5 -> {e.maml_opt_steps}, cached chain, KL from "
        f"the surrogate pass: {rows[-1]['s']:.3f} s per meta-iteration, "
        f"peak memory {peak_gb:.2f} GiB, {per_iter} kernel launches per "
        f"meta-iteration ({card})")
    return dict(launches=launches, per_iteration=per_iter,
                s=rows[-1]["s"], peak_gb=peak_gb)


def phase_gpt_ppo(dev, card: str) -> int:
    """train_gpt --algo ppo --aux-coeff 0.1 through ``run_ppo``; one
    warm-up and one timed iteration."""
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.training import train_gpt
    from arcle_tpu_torch.training.train import run_ppo
    from arcle_tpu_torch.utils import MetricLogger

    cfg, _ = train_gpt.parse_config(["--algo", "ppo", "--aux-coeff", "0.1",
                                     "--device", "cuda", "--iterations",
                                     "2"])
    cfg = dataclasses.replace(cfg, checkpoint_every=0)
    T, n = cfg.env.episode_limit, cfg.env.n_envs
    aux = ("aux_loss", "aux_rtm1_loss", "aux_r_loss", "aux_grid_loss")
    rows = []

    def on_iteration(i, run, traj, stats):
        launches = step_kernel.LAUNCHES - sum(r["launches"] for r in rows)
        if launches != T:
            raise AssertionError(f"gpt-ppo: iteration {i} launched the step "
                                 f"kernel {launches} times, not {T}")
        vals = {k: float(stats[k]) for k in aux + ("total_loss",)}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"gpt-ppo: iteration {i}: {vals}")
        rows.append(dict(vals, launches=launches,
                         rollout_ms=stats["rollout_ms"],
                         update_ms=stats["update_ms"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    run_ppo(cfg, MetricLogger(None), on_iteration=on_iteration)
    torch.cuda.synchronize()
    launches = step_kernel.LAUNCHES
    count_epilogues("gpt_ppo", launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if len(rows) != cfg.total_iterations:
        raise AssertionError(f"gpt-ppo: {len(rows)} iterations ran")
    for i, r in enumerate(rows):
        ms = r["rollout_ms"] + r["update_ms"]
        log(f"gpt-ppo iter {i}{' (warm-up)' if i == 0 else ''}: "
            f"{ms:.1f} ms/iter = rollout {r['rollout_ms']:.1f} + update "
            f"{r['update_ms']:.1f} ms (CUDA events), "
            f"{n * T / ms * 1e3:,.0f} env-steps/s incl. learner; loss "
            f"{r['total_loss']:.5f}, aux " + ", ".join(
                f"{k} {r[k]:.5f}" for k in aux) + f" ({card})")
    g = cfg.gpt
    log(f"gpt-ppo: train_gpt --algo ppo --aux-coeff 0.1, GPT {g.n_layer}L/"
        f"{g.n_head}H/{g.n_embd}E {g.dtype}, {n} envs x T={T}, "
        f"{cfg.ppo.n_minibatches} minibatches: "
        f"peak memory {peak_gb:.2f} GiB, {launches} kernel launches in "
        f"{len(rows)} iterations ({card})")
    return launches


def _scaled_close(what: str, got: torch.Tensor, want: torch.Tensor,
                  scale: float, tol: float) -> float:
    """``got`` (from the card) against ``want`` within ``tol * scale``;
    returns the error as a share of ``scale``."""
    g = got.float().cpu()
    if tuple(g.shape) != tuple(want.shape) or \
            not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: shape {tuple(g.shape)} or not finite")
    err = max_abs_diff(g, want.float())
    if not err <= tol * scale:
        raise AssertionError(f"{what}: card vs cpu {err:.3e} > {tol} x "
                             f"{scale:.3e}")
    return err / scale


def answer_given_policy_check(dev, card: str) -> None:
    """The §4.1 policy at full width on the card against the CPU, same
    weights: both passes of the model and the agent's ``evaluate_fn``, for
    the colour-equivariant and the sequential architecture, float32 and
    bf16."""
    from arcle_tpu_torch.benchmarks import (
        answer_given_agent, answer_given_env, answer_obs, make_policy)
    from arcle_tpu_torch.benchmarks.answer_given import _unpack
    from arcle_tpu_torch.models import GPTPolicy

    n = AG_POLICY_B
    env = answer_given_env(n_tasks=1024, seed=1, device="cpu")
    obs = answer_obs(env.reset(torch.Generator().manual_seed(0), n).env)
    gen = torch.Generator().manual_seed(1)
    acts = torch.cat([torch.randint(0, 5, (n, 4), generator=gen),
                      torch.randint(0, 10, (n, 1), generator=gen)],
                     1).to(torch.int32)
    grid, gd, ans, ad = _unpack(obs, 5, 5)
    z = torch.zeros(n, dtype=torch.int8)
    args_c = [grid, gd, ans, ad, z, z]
    passes = {"plain": {}, "conditioned": dict(
        operation=acts[:, 4], bbox=acts[:, :4].float() / 5)}
    worst, ms = {}, {}
    for arch in ("color_eq", "sequential"):
        ref = {}
        for dname, dtype in (("float32", torch.float32),
                             ("bf16", torch.bfloat16)):
            base = make_policy(color_equivariant=(arch == "color_eq"))
            pol_c = GPTPolicy(dataclasses.replace(base.cfg, dtype=dtype),
                              generator=torch.Generator().manual_seed(0))
            pol_g = copy.deepcopy(pol_c).to(dev)
            tol = GPT_F32_TOL if dname == "float32" else GPT_BF16_TOL
            outs = {}
            with torch.no_grad():
                for pname, kw in passes.items():
                    kw_g = {k: v.to(dev) for k, v in kw.items()}
                    args_g = [a.to(dev) for a in args_c]
                    outs[pname] = (pol_c(*args_c, **kw),
                                   pol_g(*args_g, **kw_g))
                    ms[f"{arch} {dname} {pname}"] = min(_event_ms(
                        lambda: pol_g(*args_g, **kw_g), 10)
                        for _ in range(2))
                agent = answer_given_agent(
                    pol_c, sequential=(arch == "sequential"))
                names = ("log_prob", "value", "entropy")
                outs["evaluate_fn"] = (
                    dict(zip(names, agent.evaluate_fn(pol_c, obs, acts))),
                    dict(zip(names, agent.evaluate_fn(
                        pol_g, obs.to(dev), acts.to(dev)))))
            if dname == "float32":
                ref = {p: o[0] for p, o in outs.items()}
            for pname, (out_c, out_g) in outs.items():
                for k, c in out_c.items():
                    scale = float(ref[pname][k].abs().max())
                    share = _scaled_close(
                        f"answer-given: {arch} {dname} {pname} {k}",
                        out_g[k], c, scale, tol)
                    key = f"{arch} {dname}"
                    worst[key] = max(worst.get(key, 0.0), share)
    c = base.cfg
    log(f"answer-given policy: {c.n_layer}L/{c.n_head}H/{c.n_embd}E "
        f"T={c.num_tokens}, B={n}, card vs cpu, both passes and "
        "evaluate_fn: " + ", ".join(f"{k} worst {v:.3e}"
                                    for k, v in worst.items())
        + f" of each output's scale (tol float32 {GPT_F32_TOL}, bf16 "
        f"{GPT_BF16_TOL}); TF32 off")
    log(f"timing answer-given forward B={n}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items())
        + f" (CUDA events, 10 calls; {card})")


def mlp_bf16_check(dev, card: str) -> None:
    """One forward of the full-width FCPolicy with the bf16 torso on the
    card against the CPU, same weights, on observations of the train
    configuration's envs; the float32 torso beside it."""
    from arcle_tpu_torch.benchmarks.bench import train_config
    from arcle_tpu_torch.models import FCPolicy
    from arcle_tpu_torch.training.train import setup_ppo

    run = setup_ppo(train_config("cuda", 256, 1))
    obs_g = run.agent.obs_fn(run.bs.env)
    obs_c = obs_g.cpu()
    worst, ms = {}, {}
    for dname, dtype in (("float32", torch.float32),
                         ("bf16", torch.bfloat16)):
        pol_c = FCPolicy(hidden=run.params.hidden, dtype=dtype,
                         generator=torch.Generator().manual_seed(0))
        pol_g = copy.deepcopy(pol_c).to(dev)
        with torch.no_grad():
            (l_c, v_c), (l_g, v_g) = pol_c(obs_c), pol_g(obs_g)
            ms[dname] = min(_event_ms(lambda: pol_g(obs_g), 10)
                            for _ in range(2))
        tol = 1e-4 if dname == "float32" else MLP_BF16_TOL
        for k, (g, c) in enumerate(zip(l_g + (v_g,), l_c + (v_c,))):
            share = _scaled_close(f"mlp {dname}: output {k}", g, c,
                                  float(c.abs().max()), tol)
            worst[dname] = max(worst.get(dname, 0.0), share)
    log(f"mlp bf16: FCPolicy hidden={run.params.hidden}, B={obs_c.shape[0]}, "
        f"card vs cpu, five logit heads and the value: bf16 torso worst "
        f"{worst['bf16']:.3e} of each output's largest magnitude (tol "
        f"{MLP_BF16_TOL}), float32 torso worst {worst['float32']:.3e} (tol "
        f"1e-4); forward float32 {ms['float32']:.3f} ms, bf16 "
        f"{ms['bf16']:.3f} ms (CUDA events, 10 calls; {card})")


def phase_answer_given(dev, card: str) -> dict:
    """train_answer_given's defaults through ``train``: one warm-up and two
    timed iterations; then the evaluator on the run's checkpoint."""
    import tempfile
    from arcle_tpu_torch.benchmarks import eval_answer_given
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.training import train_answer_given as tag_train
    from arcle_tpu_torch.utils import MetricLogger

    answer_given_policy_check(dev, card)
    mlp_bf16_check(dev, card)

    aux = ("aux_loss", "aux_rtm1_loss", "aux_r_loss", "aux_grid_loss")
    rows = []

    def on_iteration(i, run, traj, stats):
        launches = step_kernel.LAUNCHES - sum(r["launches"] for r in rows)
        if launches != AG_T:
            raise AssertionError(f"answer-given: iteration {i} launched the "
                                 f"step kernel {launches} times, not {AG_T}")
        vals = {k: float(stats[k]) for k in aux + (
            "total_loss", "policy_loss", "vf_loss", "entropy",
            "success_rate", "episode_reward_mean", "episode_len_mean")}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError(f"answer-given: iteration {i}: {vals}")
        episodes = int(stats["episodes"])
        if episodes < AG_B:
            raise AssertionError(f"answer-given: iteration {i}: {episodes} "
                                 "episodes finished")
        if tuple(traj.obs.shape) != (AG_T, AG_B, 54) or \
                float(traj.rewards.max()) > 0 or \
                float(traj.rewards.min()) < -1:
            raise AssertionError(f"answer-given: iteration {i}: obs "
                                 f"{tuple(traj.obs.shape)} or a reward "
                                 "outside [-1, 0]")
        rows.append(dict(vals, launches=launches, episodes=episodes,
                         rollout_ms=stats["rollout_ms"],
                         update_ms=stats["update_ms"]))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        args = tag_train.parse_args(["--device", "cuda", "--iterations",
                                     "3",
                                     "--ckpt-dir", ckpt_dir])
        if (args.n_envs, args.rollout, args.n_tasks, args.epochs,
                args.minibatches) != (AG_B, AG_T, 16384, 4, 8):
            raise AssertionError("answer-given: the trainer's defaults moved")
        init = tag_train.build(args)[1].init_fn(
            torch.Generator().manual_seed(args.seed))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        pol = tag_train.train(args, MetricLogger(None),
                              on_iteration=on_iteration)
        torch.cuda.synchronize()
        launches = step_kernel.LAUNCHES
        total_s = time.perf_counter() - t0
        count_epilogues("answer_given", launches)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        zero_launches()                    # the evaluator: no auto-reset
        it, scores = eval_answer_given.evaluate(ckpt_dir, device="cuda")
        torch.cuda.synchronize()
        count_epilogues("answer_given_eval", step_kernel.LAUNCHES)
    if len(rows) != args.iterations:
        raise AssertionError(f"answer-given: {len(rows)} iterations ran")
    if all(torch.equal(a.cpu(), b) for a, b in
           zip(pol.state_dict().values(), init.state_dict().values())):
        raise AssertionError("answer-given: the params did not change")
    if it != 0 or set(scores) != {"deterministic", "stochastic"} or not all(
            0.0 <= m["success_rate"] <= 1.0 for m in scores.values()):
        raise AssertionError(f"answer-given: evaluator gave {it}, {scores}")
    for i, r in enumerate(rows):
        ms = r["rollout_ms"] + r["update_ms"]
        log(f"answer-given iter {i}{' (warm-up)' if i == 0 else ''}: "
            f"{ms:.1f} ms/iter = rollout {r['rollout_ms']:.1f} + update "
            f"{r['update_ms']:.1f} ms (CUDA events), "
            f"{AG_B * AG_T / ms * 1e3:,.0f} env-steps/s incl. learner; loss "
            f"{r['total_loss']:.5f}, entropy {r['entropy']:.4f}, aux "
            + ", ".join(f"{k} {r[k]:.5f}" for k in aux)
            + f"; {r['episodes']} episodes, success "
            f"{r['success_rate']:.4f}, episode reward "
            f"{r['episode_reward_mean']:.3f} ({card})")
    timed = rows[1:]
    ms = sum(r["rollout_ms"] + r["update_ms"] for r in timed) / len(timed)
    roll = sum(r["rollout_ms"] for r in timed) / len(timed)
    c = pol.cfg
    log(f"answer-given: train_answer_given defaults (random setting, "
        f"{args.n_tasks} tasks, {AG_B} envs x T={AG_T}, {args.arch}, "
        f"{args.bbox_dist} head, --aux {args.aux}, potential shaping, "
        f"{args.epochs} epochs x {args.minibatches} minibatches of "
        f"{AG_B * AG_T // args.minibatches} rows), GPT {c.n_layer}L/"
        f"{c.n_head}H/{c.n_embd}E {c.dtype} T={c.num_tokens}, {len(timed)} "
        f"timed iterations: {ms:.1f} ms/iter, "
        f"{AG_B * AG_T / ms * 1e3:,.0f} env-steps/s incl. learner, rollout "
        f"{roll / ms:.1%} / update {1 - roll / ms:.1%}, peak memory "
        f"{peak_gb:.2f} GiB, {launches} kernel launches in {len(rows)} "
        f"iterations ({AG_T} each), {total_s:.1f} s with set-up (host "
        f"clock); evaluator on checkpoint {it}: deterministic success "
        f"{scores['deterministic']['success_rate']:.3f}, stochastic "
        f"{scores['stochastic']['success_rate']:.3f} ({card})")
    return dict(launches=launches, ms=ms, rollout_ms=roll, peak_gb=peak_gb)


def phase_dt(dev, card: str) -> dict:
    """The DT policy at full width on the card against the CPU, same
    weights and golden-trace batch: the float32 forward, ``bc_loss`` and
    one gradient; then ``train_bc`` on the card, ms per step and peak
    memory."""
    from arcle_tpu_torch.models import DTConfig, DTPolicy
    from arcle_tpu_torch.training import dt_bc
    from arcle_tpu_torch.validation import generate_golden_traces

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("dt: float32 matmuls are not full float32")
    tasks, traces, infos = generate_golden_traces(n_traces=DT_TRACES,
                                                  seed=11, n_steps=DT_T)
    batch_c = dt_bc.dataset_from_traces(tasks, traces, infos, T_max=DT_T,
                                        device="cpu")
    batch_g = batch_c.to(dev)
    pol_c = DTPolicy(DTConfig(), torch.Generator().manual_seed(0))
    pol_g = copy.deepcopy(pol_c).to(dev)
    with torch.no_grad():
        out_c = pol_c(*batch_c[:4])
        out_g = pol_g(*batch_g[:4])
    worst = 0.0
    for k, c in out_c.items():
        worst = max(worst, _scaled_close(f"dt: {k}", out_g[k], c,
                                         float(c.abs().max()), DT_F32_TOL))
    losses = {}
    for name, pol, batch in (("cuda", pol_g, batch_g),
                             ("cpu", pol_c, batch_c)):
        loss = dt_bc.bc_loss(pol, batch)
        loss.backward()
        losses[name] = float(loss.detach())
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not rel <= DT_LOSS_RTOL:
        raise AssertionError(f"dt: bc_loss card {losses['cuda']} vs cpu "
                             f"{losses['cpu']}")
    # GPT_GRAD_TOL's rule: 1e-3 of each tensor's largest entry plus 1e-6 of
    # the largest of all (the key bias's gradient cancels to ~0)
    grads_g = dict(pol_g.named_parameters())
    grads_c = {k: p.grad for k, p in pol_c.named_parameters()
               if p.grad is not None}        # head_value: off the BC loss
    if {k for k, p in grads_g.items() if p.grad is not None} != set(grads_c):
        raise AssertionError("dt: gradients reach other parameters")
    top = max(float(g.abs().max()) for g in grads_c.values())
    worst_grad = 0.0
    for k, c in grads_c.items():
        scale = float(c.abs().max())
        err = max_abs_diff(grads_g[k].grad.cpu(), c)
        if not err <= DT_GRAD_TOL * scale + 1e-6 * top:
            raise AssertionError(f"dt: grad {k} card vs cpu {err:.3e} > "
                                 f"{DT_GRAD_TOL} x {scale:.3e} + 1e-6 x "
                                 f"{top:.3e}")
        worst_grad = max(worst_grad, err / (scale + 1e-3 * top))

    # warm-up: in a fresh process on an H100 a cold train_bc took ~9.7 s
    # for 50 steps whose warm steps take ~10 ms each; time warm steps
    dt_bc.train_bc(DTPolicy(DTConfig()), batch_g, n_steps=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _, bc = dt_bc.train_bc(DTPolicy(DTConfig()), batch_g,
                           torch.Generator().manual_seed(0), n_steps=DT_STEPS,
                           device=dev)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / DT_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    bc = bc.cpu()
    if not bool(torch.isfinite(bc).all()) or \
            not float(bc[-1]) < 0.9 * float(bc[0]):
        raise AssertionError(f"dt: train_bc losses {bc[0]:.4f} -> "
                             f"{bc[-1]:.4f} (not finite, or not below 0.9x)")
    c = pol_c.cfg
    B, T = batch_c.rtg.shape
    log(f"dt: DTConfig() {c.n_layer}L/{c.n_head}H/{c.n_embd}E, {B} golden "
        f"traces x T={T} ({3 * T} tokens), card vs cpu float32: outputs "
        f"worst {worst:.3e} of each output's scale (tol {DT_F32_TOL}), "
        f"bc_loss {losses['cuda']:.6f} vs {losses['cpu']:.6f} (rel "
        f"{rel:.2e}, tol {DT_LOSS_RTOL}), gradient worst {worst_grad:.3e} "
        f"of each tensor's scale (tol {DT_GRAD_TOL}, + 1e-6 of the largest "
        f"gradient {top:.3e}), {len(grads_c)} tensors; TF32 off")
    log(f"dt: train_bc {DT_STEPS} full-batch Adam steps on the card, loss "
        f"{float(bc[0]):.4f} -> {float(bc[-1]):.4f}, {ms:.3f} ms/step "
        f"(CUDA events), peak memory {peak_gb:.3f} GiB ({card})")
    return {"ms_per_step": ms, "peak_gb": peak_gb}


def phase_parallel(dev, card: str, train: dict) -> dict:
    """The NCCL path at world size 1: init and liveness, the dry run at
    full depth, the data-parallel update of the MLP train configuration
    against the single-process one and its iterations, the 2-process Gloo
    all-reduce check and the scaling report.  Launches by path."""
    import torch.distributed as dist
    from arcle_tpu_torch.benchmarks.bench import train_config
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.parallel import (
        assert_all_processes_alive, init_multihost)
    from arcle_tpu_torch.parallel.dryrun import dryrun_multichip
    from arcle_tpu_torch.parallel.launch import free_port
    from arcle_tpu_torch.parallel.scaling import scaling_report
    from arcle_tpu_torch.training import (
        batch_from_trajectory, make_optimizer, rollout, train_step)
    from arcle_tpu_torch.training.train import ppo_iteration, setup_ppo

    t0 = time.perf_counter()
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=60.0,
                   device="cuda")
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"parallel: backend {dist.get_backend()}")
        assert_all_processes_alive(timeout_s=30.0)
        init_s = time.perf_counter() - t0

        zero_launches()
        dry = dryrun_multichip(1, device="cuda", report=False)
        dry_launches = step_kernel.LAUNCHES
        count_epilogues("dryrun", dry_launches)
        if dry_launches != DRYRUN_T or dry["launches"] != DRYRUN_T:
            raise AssertionError(f"parallel: the dry run launched the step "
                                 f"kernel {dry_launches} times, not "
                                 f"{DRYRUN_T}")

        group = dist.group.WORLD
        run = setup_ppo(train_config("cuda", B, 1), group=group)
        cfg, T = run.cfg.ppo, run.n_steps
        start = copy.deepcopy(run.params)
        _, traj, last_v = rollout(run.env, run.bs, run.params, run.generator,
                                  T, run.agent)
        train_step(run.params, run.opt,
                   batch_from_trajectory(traj, last_v, cfg, group=group),
                   run.generator, run.agent, cfg, group=group,
                   rollout_steps=T)
        train_step(start, make_optimizer(start, cfg),
                   batch_from_trajectory(traj, last_v, cfg), None, run.agent,
                   cfg)
        worst = 0.0
        ref = start.state_dict()
        for k, v in run.params.state_dict().items():
            torch.testing.assert_close(v, ref[k], rtol=0, atol=DP_PARAM_TOL,
                                       msg=f"parallel: param {k}, grouped vs "
                                           "single-process update")
            worst = max(worst, max_abs_diff(v, ref[k]))

        rows = []
        zero_launches()
        for _ in range(DP_ITERS):
            before = step_kernel.LAUNCHES
            _, stats, marks = ppo_iteration(run)
            n = step_kernel.LAUNCHES - before
            if n != T:
                raise AssertionError(f"parallel: a DP iteration launched the "
                                     f"step kernel {n} times, not {T}")
            loss = float(stats["total_loss"])
            if not math.isfinite(loss):
                raise AssertionError(f"parallel: DP loss {loss}")
            rows.append(marks.ms())
        dp_launches = step_kernel.LAUNCHES
        count_epilogues("dp_ppo", dp_launches)
        timed = rows[1:]
        roll = sum(r[0] for r in timed) / len(timed)
        upd = sum(r[1] for r in timed) / len(timed)
        log(f"parallel: NCCL world 1 init + liveness {init_s:.2f} s; dry run "
            f"GPTConfig() {dry['envs_per_rank']} envs x T={DRYRUN_T}, loss "
            f"{dry['loss']:.4f}, {dry_launches} launches")
        log(f"parallel: DP update (NCCL group of 1) vs single-process "
            f"train_step, {B} envs x T={T} FCPolicy: worst param diff "
            f"{worst:.3e} (tol {DP_PARAM_TOL}); {len(timed)} timed DP "
            f"iterations: {roll + upd:.1f} ms/iter = rollout {roll:.1f} + "
            f"update {upd:.1f} ms (CUDA events), vs the train phase's "
            f"{train['ms']:.1f} ms/iter with update {train['update_ms']:.1f} "
            f"ms; {dp_launches} launches in {DP_ITERS} iterations ({card})")

        rep = scaling_report(
            (1,), update_period_s=train["update_ms"] / 1e3,
            period_source=f"{card} (chip_smoke train phase, run_ppo update, "
                          f"{B} envs x T=100)", device="cuda")
        val = rep["collective_validation"]
        if not (val["measured_s"] > 0 and min(val["probe_s"]) > 0):
            raise AssertionError(f"parallel: all-reduce times {val}")
        sweep = rep["sweep"][0]
        if sweep["backend"] != "nccl":
            raise AssertionError(f"parallel: scaling ran on {sweep}")
        log(f"parallel: all-reduce check (2 Gloo processes on the card's "
            f"host): pred/meas {val['ratio_pred_over_meas']:.3f} for "
            f"{val['grad_mb']:.2f} MB (JAX's test band 0.3-3, not enforced); "
            f"scaling d=1 NCCL {sweep['iter_s'] * 1e3:.1f} ms/iter; "
            f"{time.perf_counter() - t0:.1f} s in this phase ({card})")
    finally:
        dist.destroy_process_group()
    return {"dryrun": dry_launches, "dp_ppo": dp_launches,
            "dp_ms": roll + upd, "dp_update_ms": upd,
            "allreduce_ratio": val["ratio_pred_over_meas"]}


def _emaml_dp_train(card: str, group) -> dict:
    """(a) train.py's default E-MAML through ``run_emaml(group=)``: one
    warm-up and one timed meta-iteration, the rollouts timed with CUDA
    events around ``task_rollout``."""
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.training import emaml, train
    from arcle_tpu_torch.utils import MetricLogger

    cfg, _ = train.parse_config(["--device", "cuda", "--iterations", "2"])
    cfg = dataclasses.replace(cfg, checkpoint_every=0)
    e = cfg.emaml
    if (cfg.algo, cfg.model, cfg.env.family, e.first_order) != \
            ("emaml", "mlp", "o2arc_crop33", False):
        raise AssertionError(f"emaml-dp: train.py's default is {cfg}")
    per_iter = e.rollout_steps * (e.inner_steps + 1)
    n_envs = e.n_tasks * e.envs_per_task
    init = train.build_agent(cfg).init_fn(
        torch.Generator().manual_seed(cfg.seed))
    rows, marks, t_prev = [], [], [0.0]
    kc = [torch.full((e.n_tasks, e.inner_steps), 0.0005)]
    real = emaml.task_rollout

    def timed_rollout(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        marks.append((start, end))
        return out

    def on_iteration(i, st, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        launches = step_kernel.LAUNCHES - sum(r["launches"] for r in rows)
        if launches != per_iter:
            raise AssertionError(f"emaml-dp: meta-iteration {i} launched the "
                                 f"step kernel {launches} times, not "
                                 f"{per_iter}")
        loss = float(m["meta_loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"emaml-dp: meta-iteration {i} loss {loss}")
        kls = m["inner_kls"].cpu()
        check_kl_ladder("emaml-dp", e, kc[0], kls, st.kl_coeffs)
        kc[0] = st.kl_coeffs.cpu()
        rows.append(dict(loss=loss, launches=launches, s=now - t_prev[0],
                         rollout=sum(a.elapsed_time(b) for a, b in marks)
                         / 1e3, post=float(m["post_eprew_mean"])))
        marks.clear()
        t_prev[0] = now

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    emaml.task_rollout = timed_rollout
    try:
        zero_launches()
        t_prev[0] = time.perf_counter()
        pol = train.run_emaml(cfg, MetricLogger(None),
                              on_iteration=on_iteration, group=group)
        torch.cuda.synchronize()
        launches = step_kernel.LAUNCHES
        count_epilogues("emaml_dp", launches)
    finally:
        emaml.task_rollout = real
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if len(rows) != cfg.total_iterations:
        raise AssertionError(f"emaml-dp: {len(rows)} meta-iterations ran")
    if all(torch.equal(a.cpu(), b) for a, b in
           zip(pol.state_dict().values(), init.state_dict().values())):
        raise AssertionError("emaml-dp: the params did not change")
    env_steps = n_envs * per_iter
    for i, r in enumerate(rows):
        tag = " (warm-up, set-up included)" if i == 0 else ""
        log(f"emaml-dp meta-iteration {i}{tag}: {r['s']:.3f} s (host "
            f"clock), rollouts {r['rollout']:.3f} s "
            f"({r['rollout'] / r['s']:.1%}; CUDA events around "
            f"task_rollout), "
            f"{env_steps / r['s']:,.1f} env-steps/s; meta loss "
            f"{r['loss']:.5f}, post eprew {r['post']:.3f}; "
            f"{r['launches']} kernel launches at B={n_envs} ({card})")
    log(f"emaml-dp: train.py's default E-MAML under an NCCL group of one, "
        f"FCPolicy hidden={pol.hidden}, {e.n_tasks} tasks x "
        f"{e.envs_per_task} envs x {e.rollout_steps} steps, inner_steps "
        f"{e.inner_steps}, maml_opt_steps {e.maml_opt_steps}, second "
        f"order: "
        f"{rows[-1]['s']:.3f} s per meta-iteration, peak memory "
        f"{peak_gb:.2f} GiB, {per_iter} kernel launches per meta-iteration "
        f"({card})")
    return dict(launches=launches, per_iteration=per_iter, s=rows[-1]["s"],
                rollout_share=rows[-1]["rollout"] / rows[-1]["s"],
                env_steps_per_s=env_steps / rows[-1]["s"], peak_gb=peak_gb)


def _emaml_dp_parity(dev, card: str, group) -> None:
    """(b) the grouped fused step against the single-process one from the
    same start, on the trajectories the single-process step rolled out."""
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.parallel.mesh import task_layout
    from arcle_tpu_torch.training import emaml, train
    from arcle_tpu_torch.utils import make_loader, make_table

    cfg, _ = train.parse_config(["--device", "cuda"])
    e = cfg.emaml
    agent = train.build_agent(cfg)
    bank = make_loader(cfg.env).bank(device=dev)
    n_bank = int(bank.n_tasks)
    assign = emaml.sample_task_assignment(
        torch.Generator(device=dev).manual_seed(5), n_bank, e)
    env = BatchedEnv(table=make_table(cfg.env), bank=bank,
                     max_trial=cfg.env.max_trial,
                     episode_limit=cfg.env.episode_limit, auto_reset=True,
                     dense_reward=cfg.env.dense_reward,
                     augment=cfg.env.augment, reset_pool=cfg.env.reset_pool,
                     opts=ResetOptions.make(prob_index=assign, device=dev))
    bs = env.reset(torch.Generator(device=dev).manual_seed(6),
                   e.n_tasks * e.envs_per_task)
    states = [emaml.init_emaml(agent, e, cfg.seed, n_bank, dev)
              for _ in range(2)]
    recorded, replayed = [], []
    real = emaml.task_rollout

    def recording(*args):
        res = real(*args)
        recorded.append(res[1:])
        return res

    def replaying(env_, bs_, *args):
        traj, last_v = recorded[len(replayed)]
        replayed.append(True)
        return bs_, traj, last_v

    try:
        emaml.task_rollout = recording
        st1, _, m1 = emaml.emaml_train_step(states[0], env, bs, agent, e)
        emaml.task_rollout = replaying
        st2, _, m2 = emaml.emaml_train_step(
            states[1], env, bs, agent, e,
            group=task_layout(e.n_tasks, e.envs_per_task, group))
    finally:
        emaml.task_rollout = real
    if not len(replayed) == len(recorded) == e.inner_steps + 1:
        raise AssertionError(f"emaml-dp: {len(recorded)} rollouts recorded, "
                             f"{len(replayed)} replayed")
    l1, l2 = float(m1["meta_loss"]), float(m2["meta_loss"])
    if not abs(l2 - l1) <= EMAML_DP_LOSS_RTOL * abs(l1):
        raise AssertionError(f"emaml-dp: grouped meta loss {l2} vs "
                             f"single-process {l1}")
    worst, moved = 0.0, 0.0
    ref = st1.params.state_dict()
    for k, v in st2.params.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=DP_PARAM_TOL,
                                   msg=f"emaml-dp: param {k}, grouped vs "
                                       "single-process step")
        worst = max(worst, max_abs_diff(v, ref[k]))
    for k in ("kl_coeffs", "tasks_covered", "tasks_succeeded"):
        if not torch.equal(getattr(st1, k), getattr(st2, k)):
            raise AssertionError(f"emaml-dp: {k} differ")
    log(f"emaml-dp: the fused second-order step under the NCCL group vs "
        f"the single-process step, train.py's default at full width, the "
        f"same {len(recorded)} rollouts: meta loss {l2:.6f} vs {l1:.6f} "
        f"(rtol {EMAML_DP_LOSS_RTOL}), worst param diff {worst:.3e} (tol "
        f"{DP_PARAM_TOL}), no tensor left out; KL ladder and bookkeeping "
        f"equal ({card})")


def _emaml_dp_gpt(card: str, group) -> dict:
    """(c) train_gpt's chunked, cached-chain E-MAML under the group,
    ``phase_emaml``'s cut, one meta-iteration."""
    from arcle_tpu_torch.ops import step_kernel
    from arcle_tpu_torch.training import train_gpt
    from arcle_tpu_torch.training.train import run_emaml
    from arcle_tpu_torch.utils import MetricLogger

    cfg, _ = train_gpt.parse_config([
        "--device", "cuda", "--iterations", "1",
        "--inner-steps", str(EMAML_INNER), "--meta-steps", str(EMAML_META)])
    cfg = dataclasses.replace(cfg, checkpoint_every=0)
    e = cfg.emaml
    per_iter = e.rollout_steps * (e.inner_steps + 1)
    rows = []

    def on_iteration(i, st, m):
        loss = float(m["meta_loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"emaml-dp gpt: loss {loss}")
        rows.append(dict(loss=loss, units=m["unit_times"]))

    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    run_emaml(cfg, MetricLogger(None), on_iteration=on_iteration,
              profile=True, group=group)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches = step_kernel.LAUNCHES
    count_epilogues("emaml_dp_gpt", launches)
    if launches != per_iter or len(rows) != 1:
        raise AssertionError(f"emaml-dp gpt: {launches} step-kernel "
                             f"launches in {len(rows)} meta-iterations, not "
                             f"{per_iter}")
    units = rows[0]["units"]
    log(f"emaml-dp gpt: train_gpt's chunked cached-chain E-MAML under the "
        f"NCCL group, inner / meta steps cut to {e.inner_steps} / "
        f"{e.maml_opt_steps}: {s:.3f} s for one meta-iteration (host clock, "
        f"set-up included), units " + ", ".join(
            f"{k} {v['s']:.3f} s" for k, v in units.items())
        + f" (CUDA events); meta loss {rows[0]['loss']:.5f}; {launches} "
        f"kernel launches at B={e.n_tasks * e.envs_per_task} ({card})")
    return dict(launches=launches, s=s)


def phase_emaml_dp(dev, card: str) -> dict:
    """E-MAML under an NCCL group of one: (a) train.py's default path, (b)
    the grouped learner against the single-process one, (c) train_gpt's
    chunked step under the group.  Launches by path."""
    import torch.distributed as dist
    from arcle_tpu_torch.parallel import init_multihost
    from arcle_tpu_torch.parallel.launch import free_port

    t0 = time.perf_counter()
    init_multihost(f"127.0.0.1:{free_port()}", 1, 0, timeout_s=60.0,
                   device="cuda")
    try:
        group = dist.group.WORLD
        if dist.get_backend(group) != "nccl":
            raise AssertionError(f"emaml-dp: backend {dist.get_backend()}")
        train_out = _emaml_dp_train(card, group)
        _emaml_dp_parity(dev, card, group)
        gpt_out = _emaml_dp_gpt(card, group)
    finally:
        dist.destroy_process_group()
    log(f"emaml-dp: {time.perf_counter() - t0:.1f} s in this phase ({card})")
    return dict(train_out, gpt_launches=gpt_out["launches"],
                gpt_s=gpt_out["s"])


BENCH_KEYS = {
    "": ("metric", "value", "unit", "vs_baseline", "baseline", "roofline",
         "configs", "ppo_train_loop_steps_per_s", "ppo_train_loop",
         "device"),
    "configs": ("raw_miniarc_1env", "raw_miniarc_1env_native",
                "raw_arc_256env", "arc_point_1024env",
                "reset_4096env_3200pair_ms", "reset_4096env_eager_ms",
                "corpus_pairs", "roofline"),
    "roofline": ("device_kind", "power_limit_w",
                 "analytic_bytes_per_env_step", "analytic_hbm_util_pct",
                 "device_busy_pct", "engine", "bind", "rollout_ms",
                 "launches"),
    "ppo_train_loop": ("ms_per_iter", "rollout_ms", "update_ms", "dtype",
                       "flops_per_env_step", "mfu_pct", "mfu_peak"),
}
SHARES = ("analytic_hbm_util_pct", "device_busy_pct", "mfu_pct")


def check_bench(out: dict, args, card: str) -> None:
    """``bench_cuda.run``'s result: every key, positive finite rates,
    shares in [0, 100], ``bind`` as the busy share gives it, the kernel on
    every engine path and the launches its rollouts must make."""
    from arcle_tpu_torch.benchmarks import bench

    def need(where: str, d: dict, keys) -> None:
        missing = [k for k in keys if k not in d]
        if missing:
            raise AssertionError(f"bench: {where or 'result'} lacks "
                                 f"{missing}")

    need("", out, BENCH_KEYS[""])
    need("configs", out["configs"], BENCH_KEYS["configs"])
    need("ppo_train_loop", out["ppo_train_loop"], BENCH_KEYS["ppo_train_loop"])
    cfg_steps = min(args.steps, 100)
    utils = [("roofline", out["roofline"], args.steps, args.iters)] + [
        (f"configs.roofline.{k}", u, cfg_steps, 2)
        for k, u in out["configs"]["roofline"].items()]
    rates = {"value": out["value"], "vs_baseline": out["vs_baseline"],
             "ppo_train_loop_steps_per_s": out["ppo_train_loop_steps_per_s"],
             **{f"configs.{k}": v for k, v in out["configs"].items()
                if k != "roofline"}}
    shares = {"ppo_train_loop.mfu_pct": out["ppo_train_loop"]["mfu_pct"]}
    for where, u, steps, iters in utils:
        need(where, u, BENCH_KEYS["roofline"])
        shares.update({f"{where}.{k}": u[k] for k in SHARES if k in u})
        if u["engine"] != "cuda":
            raise AssertionError(f"bench: {where} ran the {u['engine']} step")
        want = steps * (iters + 2) + min(steps, bench.BYTES_STEPS)
        if u["launches"] != want:
            raise AssertionError(f"bench: {where} launched the kernel "
                                 f"{u['launches']} times, not {want}")
        bind = "host" if u["device_busy_pct"] < bench.BUSY_DEVICE_PCT \
            else "device"
        if u["bind"] != bind:
            raise AssertionError(f"bench: {where} bind {u['bind']} at "
                                 f"{u['device_busy_pct']}% busy")
    for k, v in rates.items():
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"bench: {k} = {v}")
    for k, v in shares.items():
        if not (isinstance(v, (int, float)) and 0 <= v <= 100):
            raise AssertionError(f"bench: share {k} = {v}")
    if out["device"]["name"] != card.rsplit(",", 1)[0] or \
            not out["device"]["power_limit_w"] > 0:
        raise AssertionError(f"bench: device {out['device']}, not {card}")


def phase_bench(dev, card: str) -> dict:
    """``bench_cuda.py`` at its defaults through ``bench_cuda.run``: the
    engine (4096 x 100, best of 5), the reference's single-env baseline
    (3,000 oracle steps), BASELINE's configurations and the train loop;
    the JSON line checked and printed, and the kernel's launches on the
    path counted."""
    import bench_cuda
    from arcle_tpu_torch.benchmarks import bench
    from arcle_tpu_torch.ops import step_kernel

    args = bench_cuda.parse_args([])
    zero_launches()
    t0 = time.perf_counter()
    out = bench_cuda.run(args)
    seconds = time.perf_counter() - t0
    launches = step_kernel.LAUNCHES
    check_bench(out, args, card)
    # one per card step of the single-env adapter, one per train-loop step
    # (a warm-up and 3 timed iterations) and the engine rollouts' own
    want = bench.ADAPTER_STEPS + 4 * args.steps + out["roofline"][
        "launches"] + sum(u["launches"] for u in
                          out["configs"]["roofline"].values())
    if launches != want:
        raise AssertionError(f"bench: {launches} kernel launches, not {want}")
    # every launch but the single-env adapter's goes through BatchedEnv
    count_epilogues("bench", launches - bench.ADAPTER_STEPS)
    print(json.dumps(out), flush=True)
    log(f"bench: bench_cuda.py's defaults in {seconds:.1f} s (host clock), "
        f"{launches} kernel launches; engine {out['value']:,} env-steps/s "
        f"({out['roofline']['bind']} bound, the card busy "
        f"{out['roofline']['device_busy_pct']}%), train loop "
        f"{out['ppo_train_loop_steps_per_s']:,} env-steps/s, mfu "
        f"{out['ppo_train_loop']['mfu_pct']}% of "
        f"{out['ppo_train_loop']['mfu_peak']} ({card})")
    return {"launches": launches, "configs": out["configs"]["roofline"],
            "seconds": seconds}


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


def hbm_bytes_per_s() -> float:
    """The H100 SXM's HBM rate (NVIDIA's data sheet), the bound's
    denominator."""
    from arcle_tpu_torch.benchmarks.roofline import H100_SXM
    return H100_SXM["hbm_gbps"] * 1e9


def graph_device_ms(step, st, acts, table, chain: int = 20,
                    reps: int = 20) -> float:
    """The kernel's device time per launch: ``chain`` dependent launches
    (each reads the state the previous one wrote, as the main path does)
    captured in one CUDA graph and replayed ``reps`` times between CUDA
    events, so no host time is counted."""
    s = st
    for a in acts[:3]:                     # warm-up: build, load, table rows
        s = step(s, a, table)[0]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s = st
        for k in range(chain):
            s = step(s, acts[k % len(acts)], table)[0]
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(graph.replay, reps) / chain
    del graph
    return ms


def host_us(step, st, acts, table, calls: int = 200) -> float:
    """The wrapper's host time per call: host clock over ``calls`` calls,
    no synchronise inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        step(st, acts[i % len(acts)], table)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def chain_bytes(step, st, acts, table, chain: int = 20) -> float:
    """Mean bytes per launch over the chain that ``graph_device_ms`` times."""
    from arcle_tpu_torch.benchmarks.roofline import step_kernel_bytes
    total, s = 0, st
    for k in range(chain):
        a = acts[k % len(acts)]
        total += step_kernel_bytes(s, a, table)
        s = step(s, a, table)[0]
    return total / chain


def time_groups(st, acts, table, card: str) -> None:
    """Device time and bound per op group: every env of the batch takes one
    op of the group (the same selections as the mix)."""
    from arcle_tpu_torch.core import Action
    from arcle_tpu_torch.ops.step_kernel import cuda_step_deferred
    names = ("Color3", "Flood3", "Move_U", "Rotate_90", "Flip_H", "Copy_I",
             "Paste", "CopyFromInput", "ResetGrid", "ResizeGrid", "Submit")
    parts = []
    for name, op in zip(names, (3, 13, 20, 24, 26, 28, 30, 31, 32, 33, 34)):
        one = [Action(selection=a.selection,
                      operation=torch.full_like(a.operation, op))
               for a in acts]
        nbytes = chain_bytes(cuda_step_deferred, st, one, table)
        ms = graph_device_ms(cuda_step_deferred, st, one, table)
        parts.append(f"{name} {ms * 1e3:.2f} (bound "
                     f"{nbytes / hbm_bytes_per_s() * 1e6:.2f})")
    log(f"timing kernel by op, B={B} 30x30, device us per launch: "
        f"{', '.join(parts)} ({card})")


def time_kernel(dev, card: str, H: int, W: int, batch: int = B,
                answer_given: bool = False, crop33: bool = False,
                table=None, bank=None, point: bool = False) -> dict:
    """Device time, host time, bound and plain time of the kernel at
    ``batch`` envs with random bbox actions (``point``: one pixel) on an
    ``H x W`` bank: O2ARCv2 on synthetic tasks (``crop33``: train.py's
    table, CropGrid at op 33 and max_trial=127), ``table`` on ``bank``, or
    (``answer_given``) the colour-only table on the answer-given suite's
    random pairs."""
    from arcle_tpu_torch.benchmarks import answer_given_env
    from arcle_tpu_torch.envs import BatchedEnv, random_bbox_actions
    from arcle_tpu_torch.envs.rollout import random_point_actions
    from arcle_tpu_torch.loaders import SyntheticLoader
    from arcle_tpu_torch.ops import finish_flood, o2arc_table
    from arcle_tpu_torch.ops.step_kernel import (
        cuda_step_deferred, plain_step_deferred)

    if answer_given:
        env = answer_given_env(n_tasks=4096, h=H, w=W, seed=3, device=dev)
        table, family = env.table, "colour-only table"
    else:
        if table is not None:
            family = f"{table.name} table"
        else:
            table, family = (o2arc_table(max_trial=127, crop_at_33=True),
                             "O2ARCv2 crop33") if crop33 else \
                (o2arc_table(max_trial=-1), "O2ARCv2")
        if bank is None:
            bank = SyntheticLoader(16, seed=3, min_size=2,
                                   max_size=min(H, W, 12)).bank(
                                       H, W, device=dev)
        env = BatchedEnv(table=table, bank=bank,
                         max_trial=table.max_trial, episode_limit=100,
                         auto_reset=True, reset_pool=8)
    st = env.reset(torch.Generator(device=dev).manual_seed(2), batch).env
    gen = torch.Generator(device=dev).manual_seed(3)
    draw = random_point_actions if point else random_bbox_actions
    acts = [draw(gen, batch, table.n_ops, H, W, dev) for _ in range(8)]

    def plain(s, a, t):
        s2, r, term, pend = plain_step_deferred(s, a, t)
        if bool(pend.any()):
            s2 = finish_flood(s2, a, t, pend)
        return s2, r, term, pend

    i = [0]

    def kernel_call():
        cuda_step_deferred(st, acts[i[0] % 8], table)
        i[0] += 1

    def plain_call():
        plain(st, acts[i[0] % 8], table)
        i[0] += 1

    nbytes = chain_bytes(cuda_step_deferred, st, acts, table)
    bound_ms = nbytes / hbm_bytes_per_s() * 1e3
    dev_ms = [graph_device_ms(cuda_step_deferred, st, acts, table)
              for _ in range(2)]
    h_us = [host_us(cuda_step_deferred, st, acts, table) for _ in range(2)]
    for f in (kernel_call, plain_call):
        _event_ms(f, 5)                                      # warm-up
    loop_ms = [_event_ms(kernel_call, 50) for _ in range(2)]
    plain_ms = [_event_ms(plain_call, 10) for _ in range(2)]
    if (H, W) == (30, 30) and batch == B and not answer_given:
        time_groups(st, acts, table, card)
    out = dict(device_ms=min(dev_ms), host_us=min(h_us),
               ms=min(loop_ms), plain_ms=min(plain_ms), bound_ms=bound_ms,
               bytes_per_launch=nbytes,
               roofline_share=bound_ms / min(dev_ms))
    log(f"timing kernel B={batch} {H}x{W} {family} random "
        f"{'point' if point else 'bbox'}: device "
        f"{dev_ms[0] * 1e3:.2f} / {dev_ms[1] * 1e3:.2f} us per launch "
        f"(CUDA graph of 20 dependent launches, CUDA events); bound "
        f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.3f} MB per launch at "
        f"{hbm_bytes_per_s() / 1e12:.2f} TB/s), {out['roofline_share']:.1%} "
        f"of it; wrapper host {h_us[0]:.1f} / {h_us[1]:.1f} us per call "
        f"(host clock, 200 calls); host-inclusive loop {loop_ms[0]:.4f} / "
        f"{loop_ms[1]:.4f} ms per call; plain {plain_ms[0]:.4f} / "
        f"{plain_ms[1]:.4f} ms per step ({card})")
    return out


def phase_timing(dev, card: str) -> dict:
    from arcle_tpu_torch.benchmarks.bench import CONFIG_ENVS, corpus_bank
    from arcle_tpu_torch.envs import random_bbox_rollout
    from arcle_tpu_torch.ops import arc_table, finish_flood, raw_table
    from arcle_tpu_torch.ops.step_kernel import plain_step_deferred

    by_geometry = {f"{h}x{w}": time_kernel(dev, card, h, w)
                   for h, w in ((30, 30), (5, 5))}
    # the batches the kernel is launched at: the gym adapters' single env,
    # train_gpt's E-MAML (2 tasks x 1 env) and GPT PPO (64 envs)
    for batch in (GYM_B,) + GPT_BATCHES:
        by_geometry[f"30x30_B{batch}"] = time_kernel(dev, card, 30, 30,
                                                     batch)
    # where train.py's E-MAML launches it: 10 tasks x 10 envs, crop33
    by_geometry[f"30x30_crop33_B{EMAML_DP_B}"] = time_kernel(
        dev, card, 30, 30, EMAML_DP_B, crop33=True)
    # where train_answer_given launches it: 1024 envs, 5x5, colour ops only
    by_geometry[f"5x5_color_B{AG_B}"] = time_kernel(dev, card, 5, 5, AG_B,
                                                    answer_given=True)
    # where bench_cuda's configurations launch it: Raw at 256 envs and ARC
    # with point actions at 1024 envs, on the write_corpus bank
    bank, _ = corpus_bank(dev)
    raw_b, point_b = CONFIG_ENVS
    by_geometry[f"30x30_raw_B{raw_b}"] = time_kernel(
        dev, card, 30, 30, raw_b, table=raw_table(max_trial=-1), bank=bank)
    by_geometry[f"30x30_arc_point_B{point_b}"] = time_kernel(
        dev, card, 30, 30, point_b, table=arc_table(max_trial=-1), bank=bank,
        point=True)

    env = main_env(dev)
    table = env.table
    bs = env.reset(torch.Generator(device=dev).manual_seed(2), B)
    gen = torch.Generator(device=dev).manual_seed(3)

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
    return by_geometry


def device_work(fn, steps: int, match=("step_kernel",)) -> tuple:
    """Device microseconds and device operations per step of ``fn`` (which
    runs ``steps`` steps), and the device microseconds of the kernels
    whose name holds one of ``match`` (the step kernel's share), from
    ``torch.profiler``'s device events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time for e in events)
    kernel = sum(e.device_time for e in events
                 if any(m in e.name for m in match))
    return total / steps, len(events) / steps, kernel / steps


def phase_profile(dev, card: str):
    """Device work per step of the engine loop and of the PPO rollout."""
    from arcle_tpu_torch.benchmarks.bench import train_config
    from arcle_tpu_torch.envs import random_bbox_rollout
    from arcle_tpu_torch.training import rollout
    from arcle_tpu_torch.training.train import setup_ppo

    steps = 20
    env = main_env(dev)
    bs = [env.reset(torch.Generator(device=dev).manual_seed(0), B)]
    gen = torch.Generator(device=dev).manual_seed(1)

    def engine():
        bs[0], _ = random_bbox_rollout(env, bs[0], steps, gen)
    engine()                                                # warm-up
    us, ops, k_us = device_work(engine, steps)
    log(f"profile engine loop: {us:.1f} us of device work in {ops:.1f} "
        f"device operations per step, step_kernel {k_us:.1f} us "
        f"(torch.profiler device events; {card})")

    run = setup_ppo(train_config("cuda", B, 1))

    def roll():
        rollout(run.env, run.bs, run.params, run.generator, steps, run.agent)
    roll()                                                  # warm-up
    us, ops, k_us = device_work(roll, steps)
    log(f"profile PPO rollout: {us:.1f} us of device work in {ops:.1f} "
        f"device operations per step, step_kernel {k_us:.1f} us "
        f"(torch.profiler device events; {card})")
    phase_profile_gym(dev, card)
    phase_profile_gpt(dev, card)
    phase_profile_emaml(dev, card)
    phase_profile_answer_given(dev, card)
    phase_profile_dt(dev, card)


def phase_profile_gym(dev, card: str):
    """Where an O2ARCv2 adapter step on the card goes: device work per step
    against its wall clock (torch.profiler), and the host clock of the
    engine's three parts (the selection's upload, the step, the packed
    read-back with its wait) beside the rest of the adapter."""
    import numpy as np
    from arcle_tpu_torch.envs import O2ARCv2Env
    from arcle_tpu_torch.loaders import SyntheticLoader

    env = O2ARCv2Env(data_loader=SyntheticLoader(8, seed=5),
                     backend="torch", device=dev)
    rng = np.random.default_rng(3)
    acts = [gym_random_action(rng, 35) for _ in range(500)]
    env.reset(seed=0, options={"prob_index": 0, "subprob_index": 0})
    eng = env.engine
    spent = {"upload": 0.0, "step": 0.0, "read_back": 0.0}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[name] += time.perf_counter() - t0
            return out
        return run

    def steps():
        for a in acts:
            env.step(a)
    steps()                                                 # warm-up
    t0 = time.perf_counter()
    steps()
    wall = (time.perf_counter() - t0) / len(acts) * 1e3
    us, ops, k_us = device_work(steps, len(acts))
    import arcle_tpu_torch.envs.single as single
    complete = single.complete_step
    eng._upload = timed("upload", eng._upload)
    eng._read_back = timed("read_back", eng._read_back)
    single.complete_step = timed("step", complete)
    try:
        t0 = time.perf_counter()
        steps()
        total = time.perf_counter() - t0
    finally:
        single.complete_step = complete
    split = {k: v / len(acts) * 1e6 for k, v in spent.items()}
    rest = total / len(acts) * 1e6 - sum(split.values())
    log(f"profile gym O2ARCv2 adapter (card, B=1): {us:.1f} us of device "
        f"work in {ops:.1f} device operations per step, step_kernel "
        f"{k_us:.1f} us; {wall:.3f} ms per step (host clock), the card idle "
        f"{1 - us / 1e3 / wall:.1%} of it; host per step: upload "
        f"{split['upload']:.1f} us, step (wrapper and launch) "
        f"{split['step']:.1f} us, packed read-back with its wait "
        f"{split['read_back']:.1f} us, the adapter's rest {rest:.1f} us "
        f"(torch.profiler device events, host clock; {card})")


def top_kernels(fn, k: int = 6) -> str:
    """The ``k`` device kernels with the most time in one run of ``fn``,
    each with its share of the device time (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{n[:48]} {t / total:.1%}" for n, t in top)


def phase_profile_dt(dev, card: str):
    """Device work against wall clock of ``train_bc``'s step (the forward,
    ``bc_loss``, the backward and the Adam step) on the ``dt`` phase's
    batch, after a warm-up."""
    from arcle_tpu_torch.models import DTConfig, DTPolicy
    from arcle_tpu_torch.training import dt_bc
    from arcle_tpu_torch.validation import generate_golden_traces

    tasks, traces, infos = generate_golden_traces(n_traces=DT_TRACES,
                                                  seed=11, n_steps=DT_T)
    batch = dt_bc.dataset_from_traces(tasks, traces, infos, T_max=DT_T,
                                      device=dev)
    pol = DTPolicy(DTConfig(), torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.Adam(pol.parameters(), lr=3e-4, betas=(0.9, 0.999),
                           eps=1e-8)
    steps = 10

    def bc():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            dt_bc.bc_loss(pol, batch).backward()
            opt.step()
    bc()                                                    # warm-up
    wall = _event_ms(bc, 1) / steps
    us, ops, _ = device_work(bc, steps, match=())
    log(f"profile dt train_bc step ({batch.rtg.shape[0]} traces x "
        f"T={DT_T}): {us:.1f} us of device work in {ops:.1f} device "
        f"operations per step; {wall:.3f} ms per step (CUDA events), the "
        f"card idle {max(0.0, 1 - us / 1e3 / wall):.1%} of it; top: "
        f"{top_kernels(bc)} (torch.profiler device events; {card})")


def phase_profile_answer_given(dev, card: str):
    """Device work against wall clock for train_answer_given's defaults:
    per rollout step, and per minibatch update (8192 rows, the evaluate
    and the aux pass)."""
    from arcle_tpu_torch.training import rollout, train_step
    from arcle_tpu_torch.training import train_answer_given as tag_train

    run = tag_train.setup(tag_train.parse_args(["--device", "cuda"]))
    steps = 10

    def roll():
        rollout(run.env, run.bs, run.params, run.generator, steps, run.agent)
    roll()                                                  # warm-up
    wall = _event_ms(roll, 1) / steps
    us, ops, k_us = device_work(roll, steps)
    log(f"profile answer-given rollout ({AG_B} envs): {us:.1f} us of device "
        f"work in {ops:.1f} device operations per step, step_kernel "
        f"{k_us:.1f} us; {wall:.3f} ms per step (CUDA events), the card "
        f"idle {1 - us / 1e3 / wall:.1%} of it (torch.profiler device "
        f"events; {card})")

    _, traj, last_v = rollout(run.env, run.bs, run.params, run.generator,
                              AG_T, run.agent)
    batch = tag_train.learner_batch(traj, last_v, run.pcfg, 5, True)
    one_epoch = dataclasses.replace(run.pcfg, n_epochs=1)
    n_mb = one_epoch.n_minibatches

    def update():
        train_step(run.params, run.opt, batch, run.generator, run.agent,
                   one_epoch, 0.1)
    update()                                                # warm-up
    wall = _event_ms(update, 1) / n_mb
    us, ops, _ = device_work(update, n_mb)
    log(f"profile answer-given update: {us / 1e3:.2f} ms of device work in "
        f"{ops:.0f} device operations per minibatch of "
        f"{batch.obs.shape[0] // n_mb} rows; {wall:.2f} ms per minibatch "
        f"(CUDA events), the card idle {max(0.0, 1 - us / 1e3 / wall):.1%} "
        f"of it; top kernels: {top_kernels(update)} (torch.profiler device "
        f"events; {card})")


def phase_profile_gpt(dev, card: str):
    """Device work of the default (bf16) GPT forward at the batches the
    GPT paths run it at, with the attention kernels' share; and of
    train_gpt's E-MAML rollout per step, beside its wall clock."""
    from arcle_tpu_torch.models import GPTConfig, GPTPolicy
    from arcle_tpu_torch.training import train_gpt

    pol = GPTPolicy(GPTConfig(), generator=torch.Generator().manual_seed(0))
    pol = pol.to(dev)
    names = ("grid", "grid_dim", "input", "input_dim", "trials_remain",
             "active")
    attn = ("fmha", "attention")
    for n in (1, 8, 64):
        st = gpt_state(n)
        args = [getattr(st, k).to(dev) for k in names]

        def fwd():
            with torch.no_grad():
                pol(*args)
        fwd()                                               # warm-up
        wall = _event_ms(fwd, 5)
        us, ops, a_us = device_work(fwd, 1, attn)
        log(f"profile gpt forward B={n}: {us:.1f} us of device work in "
            f"{ops:.0f} device operations, attention kernels {a_us:.1f} "
            f"us ({a_us / us:.1%}); {wall:.3f} ms per call (CUDA events) "
            f"(torch.profiler device events; {card})")

    cfg, _ = train_gpt.parse_config(["--device", "cuda"])
    profile_emaml_rollout(dev, card, cfg, "train_gpt")


def profile_emaml_rollout(dev, card: str, cfg, label: str) -> dict:
    """Device work per step of ``cfg``'s E-MAML rollout (all tasks' envs,
    one forward pair per task per step), beside its wall clock.  Returns
    the agent, the state, the env, the carry and the 10-step
    trajectory."""
    from arcle_tpu_torch.envs import BatchedEnv, ResetOptions
    from arcle_tpu_torch.training.emaml import init_emaml, task_rollout
    from arcle_tpu_torch.training.train import build_agent
    from arcle_tpu_torch.utils import make_loader, make_table

    e = cfg.emaml
    agent = build_agent(cfg)
    st = init_emaml(agent, e, 0, n_bank_tasks=cfg.env.n_synthetic_tasks,
                    device=dev)
    prob = torch.arange(e.n_tasks, device=dev).repeat_interleave(
        e.envs_per_task)
    env = BatchedEnv(table=make_table(cfg.env),
                     bank=make_loader(cfg.env).bank(device=dev),
                     max_trial=cfg.env.max_trial,
                     episode_limit=cfg.env.episode_limit,
                     dense_reward=True, augment=True,
                     reset_pool=cfg.env.reset_pool,
                     opts=ResetOptions.make(prob_index=prob, device=dev))
    out = dict(agent=agent, st=st, env=env, bs=env.reset(
        torch.Generator(device=dev).manual_seed(0),
        e.n_tasks * e.envs_per_task))
    params = [dict(st.params.named_parameters())] * e.n_tasks
    steps = 10
    short = dataclasses.replace(e, rollout_steps=steps)

    def roll():
        out["bs"], out["traj"], out["last_v"] = task_rollout(
            env, out["bs"], params, st.generator, agent, short, False)
    roll()                                                  # warm-up
    wall = _event_ms(roll, 1) / steps
    us, ops, k_us = device_work(roll, steps)
    log(f"profile E-MAML rollout ({label}, {e.n_tasks} tasks x "
        f"{e.envs_per_task} env): {us:.1f} us of device work in {ops:.1f} "
        f"device operations per step, step_kernel {k_us:.1f} us; "
        f"{wall:.3f} ms per step (CUDA events) (torch.profiler device "
        f"events; {card})")
    return out


def phase_profile_emaml(dev, card: str):
    """train.py's default E-MAML (10 tasks x 10 envs, the full-width MLP,
    second order): the rollout per step, and one task's meta-loss term,
    the second-order replay of its 5 inner steps on a 1000-row batch and
    its backward, as the fused step runs it 50 times per
    meta-iteration."""
    from arcle_tpu_torch.training import emaml, train

    cfg, _ = train.parse_config(["--device", "cuda"])
    e = cfg.emaml
    out = profile_emaml_rollout(dev, card, cfg, "train.py")
    agent, st = out["agent"], out["st"]
    # a task's batch of rollout_steps x envs_per_task rows: 10 rollouts of
    # 10 steps of its envs
    trajs = []
    for _ in range(e.rollout_steps // 10):
        out["bs"], traj, last_v = emaml.task_rollout(
            out["env"], out["bs"], [dict(st.params.named_parameters())]
            * e.n_tasks, st.generator, agent,
            dataclasses.replace(e, rollout_steps=10), False)
        trajs.append(traj)
    traj = type(trajs[0])(*(torch.cat(x) for x in zip(*trajs)))
    batch = emaml.task_batches(traj, last_v, e)[0]

    def meta_term():
        p, kls = emaml.meta_params(st.params), []
        for _ in range(e.inner_steps):
            kls.append(emaml._batch_kl(p, batch, e, agent))
            p = emaml._inner_update(p, batch, e, agent)
        loss, _ = emaml._outer_ppo_loss(p, batch, e, agent)
        (loss + torch.sum(st.kl_coeffs[0] * torch.stack(kls))).backward()
        st.opt.zero_grad(set_to_none=True)
    meta_term()                                             # warm-up
    wall = _event_ms(meta_term, 2)
    us, ops, _ = device_work(meta_term, 1)
    log(f"profile E-MAML meta term (train.py, one task, {e.inner_steps} "
        f"second-order inner steps on {batch.obs.shape[0]} rows): "
        f"{us / 1e3:.2f} ms of device work in {ops:.0f} device operations; "
        f"{wall:.2f} ms per call (CUDA events) (torch.profiler device "
        f"events; {card})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    from arcle_tpu_torch.benchmarks.roofline import card_line
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from arcle_tpu_torch.benchmarks.bench import CONFIG_ENVS
    from arcle_tpu_torch.ops import step_kernel
    raw_b, point_b = CONFIG_ENVS
    path, build_s, build_log = step_kernel.build()
    step_kernel.load()
    log(f"build: {build_s:.2f} s -> {path.name}")
    for line in build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line or \
                "Compiling entry" in line:
            log(f"build: {line.strip()}")
    log(f"build: {step_kernel.resident_warps(30, 30)} env-warps resident per "
        f"SM at 30x30, {step_kernel.resident_warps(5, 5)} at 5x5")

    if "--profile" in sys.argv[1:]:
        phase_profile(dev, card)
        return 0

    worst = phase_parity(dev)
    epilogue = phase_engine(dev)
    gym_out = phase_gym(dev, card)
    launches = {"gym": gym_out["launches"], "main": phase_main(dev)}
    phase_learner(dev)
    train = phase_train(dev, card)
    launches["train"] = train["launches"]
    timing = phase_timing(dev, card)
    t30, tag = timing["30x30"], timing[f"5x5_color_B{AG_B}"]
    t1 = timing[f"30x30_B{GYM_B}"]
    gpt_ms = phase_gpt(dev, card)
    emaml = phase_emaml(dev, card)
    launches["emaml"] = emaml["launches"]
    launches["gpt_ppo"] = phase_gpt_ppo(dev, card)
    answer_given = phase_answer_given(dev, card)
    launches["answer_given"] = answer_given["launches"]
    dt = phase_dt(dev, card)
    par = phase_parallel(dev, card, train)
    launches["dryrun"], launches["dp_ppo"] = par["dryrun"], par["dp_ppo"]
    edp = phase_emaml_dp(dev, card)
    launches["emaml_dp"], launches["emaml_dp_gpt"] = edp["launches"], \
        edp["gpt_launches"]
    t100 = timing[f"30x30_crop33_B{EMAML_DP_B}"]
    bench = phase_bench(dev, card)
    launches["bench"] = bench["launches"]

    # the answer-given paths launch the epilogue at 5x5, all others at 30x30
    epi_paths = {shape: {p: n for p, n in EPILOGUES.items()
                         if p.startswith("answer_given") == (shape == "5x5")}
                 for shape in epilogue}
    kernels = {"kernels": [{
        "name": "step_kernel", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": sum(launches.values()), "launches_by_path": launches,
        "launches_per_meta_iteration": emaml["per_iteration"],
        "launches_per_answer_given_iteration": AG_T,
        "max_abs_err": worst,
        "ms": t30["ms"], "plain_ms": t30["plain_ms"],
        "device_ms": t30["device_ms"], "host_us": t30["host_us"],
        "bound_ms": t30["bound_ms"], "bound_by": "bytes",
        "bytes_per_launch": t30["bytes_per_launch"],
        "library_ms": None, "by_geometry": timing}, {
        # the same kernel at the shape the answer-given path launches it
        "name": f"step_kernel@5x5_color_B{AG_B}", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": launches["answer_given"], "max_abs_err": worst,
        "ms": tag["ms"], "plain_ms": tag["plain_ms"],
        "device_ms": tag["device_ms"], "host_us": tag["host_us"],
        "bound_ms": tag["bound_ms"], "bound_by": "bytes",
        "bytes_per_launch": tag["bytes_per_launch"],
        "library_ms": None}, {
        # the same kernel at the shape the gym adapters launch it
        "name": f"step_kernel@30x30_B{GYM_B}", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": launches["gym"], "max_abs_err": worst,
        "ms": t1["ms"], "plain_ms": t1["plain_ms"],
        "device_ms": t1["device_ms"], "host_us": t1["host_us"],
        "bound_ms": t1["bound_ms"], "bound_by": "bytes",
        "bytes_per_launch": t1["bytes_per_launch"],
        "library_ms": None}, {
        # the same kernel at the shape train.py's E-MAML launches it
        "name": f"step_kernel@30x30_crop33_B{EMAML_DP_B}", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": launches["emaml_dp"], "max_abs_err": worst,
        "ms": t100["ms"], "plain_ms": t100["plain_ms"],
        "device_ms": t100["device_ms"], "host_us": t100["host_us"],
        "bound_ms": t100["bound_ms"], "bound_by": "bytes",
        "bytes_per_launch": t100["bytes_per_launch"],
        "library_ms": None}] + [{
        # the same kernel at the shapes bench_cuda's configurations launch
        # it (Raw at 256 envs, ARC with point actions at 1024)
        "name": f"step_kernel@{shape}", "route": "cuda",
        "source": "arcle_tpu_torch/csrc/step_kernel.cu",
        "replaces": "arcle_tpu/ops/pallas_step.py:248",
        "launches": bench["configs"][config]["launches"],
        "max_abs_err": worst,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"], "host_us": t["host_us"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "bytes_per_launch": t["bytes_per_launch"],
        "roofline_share": t["roofline_share"],
        "library_ms": None}
        for shape, config, t in (
            (f"30x30_raw_B{raw_b}", "raw_arc_256env",
             timing[f"30x30_raw_B{raw_b}"]),
            (f"30x30_arc_point_B{point_b}", "arc_point_1024env",
             timing[f"30x30_arc_point_B{point_b}"]))],
        "engine_epilogue": [{
            # the engine epilogue where the o2arc_mlp cells and the
            # answer-given suite launch it: once per BatchedEnv.step
            "name": f"engine_epilogue@{shape}", "route": "cuda",
            "source": "arcle_tpu_torch/csrc/step_kernel.cu",
            "replaces": None,
            "launches": sum(epi_paths[shape].values()),
            "launches_by_path": epi_paths[shape],
            "plain_ms": t["plain_ms"],
            "device_ms": t["device_ms"], "host_us": t["host_us"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "bytes_per_launch": t["bytes_per_launch"],
            "roofline_share": t["roofline_share"], "library_ms": None}
            for shape, t in epilogue.items()],
        "gym_steps_per_s": gym_out["rates"],
        "gym_golden_steps": gym_out["golden_steps"],
        "gpt_forward_ms": gpt_ms,
        "emaml_s_per_meta_iteration": emaml["s"],
        "emaml_peak_gb": emaml["peak_gb"],
        "answer_given_ms_per_iteration": answer_given["ms"],
        "answer_given_rollout_ms": answer_given["rollout_ms"],
        "answer_given_peak_gb": answer_given["peak_gb"],
        "dt_ms_per_step": dt["ms_per_step"], "dt_peak_gb": dt["peak_gb"],
        "dp_ppo_ms_per_iteration": par["dp_ms"],
        "dp_ppo_update_ms": par["dp_update_ms"],
        "train_ms_per_iteration": train["ms"],
        "allreduce_pred_over_meas": par["allreduce_ratio"],
        "emaml_dp_s_per_meta_iteration": edp["s"],
        "emaml_dp_rollout_share": edp["rollout_share"],
        "emaml_dp_env_steps_per_s": edp["env_steps_per_s"],
        "emaml_dp_peak_gb": edp["peak_gb"],
        "emaml_dp_gpt_s_per_meta_iteration": edp["gpt_s"],
        "bench_s": bench["seconds"]}
    log(f"total: {time.perf_counter() - t_start:.1f} s (host clock)")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
