"""The port's benchmark functions: ``bench.py``'s, over ``arcle_tpu_torch``.

Counterpart of the root ``bench.py`` (its CLI is the root
``bench_cuda.py``).  Every function takes ``device`` (default ``"cuda"``)
and draws from ``torch.Generator`` s seeded by its arguments.  On the card
the engine steps through the CUDA step kernel, and each rollout is held
to exactly one launch per step; ``device="cuda"`` without a card raises.
Nothing falls back to the CPU or to the plain step: the CPU runs only
where the caller passes ``device="cpu"``.

* :func:`bench_reference_numpy` -- one env of the reference (``arcle``,
  where it imports) or else of the port's NumPy oracle.
* :func:`bench_engine` -- 4096 lockstep O2ARCv2 envs, random bbox (or
  point) actions, auto-reset from an 8-deep pool; best of ``iters``
  rollouts, and the roofline block (:mod:`.roofline`).
* :func:`bench_single_env_adapter`, :func:`bench_baseline_configs` --
  ``BASELINE.json``'s configurations 1-3 and the reset cost.
* :func:`bench_train_loop` -- the PPO train loop (``run_ppo``'s
  iteration) at ``bench.py::bench_train_loop``'s configuration.
* :func:`bench_scaling` -- the engine on 1..n ranks, each stepping its
  block of the global batch (NCCL, one rank per card; Gloo on the CPU).
"""

from __future__ import annotations

import math
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..loaders import TaskBank
from . import roofline

ADAPTER_STEPS = 30000          # single-env adapter steps per backend
CORPUS = (400, 6, 2)           # write_corpus: tasks, train and test pairs
CONFIG_ENVS = (256, 1024)      # envs of the Raw and the ARC-point configs
RESET_ENVS = 4096              # envs per BatchedEnv.reset in the configs
BYTES_STEPS = 10               # steps whose kernel bytes are averaged
TRAIN_HIDDEN = (1024, 1024, 512, 512, 256, 128)   # the FCPolicy's torso
BUSY_DEVICE_PCT = 50.0         # busy share above which a loop is device
                               # bound, below it host bound
MFU_PEAK = {"float32": "fp32", "bfloat16": "bf16"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available (the "
                           "benchmark does not fall back to the CPU; pass "
                           "device='cpu' to run there)")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: Callable, dev: torch.device
          ) -> Tuple[float, Optional[float]]:
    """Seconds of ``fn()``: on the host clock ending in a synchronize, and
    between CUDA events on a card (None on the CPU)."""
    cuda = dev.type == "cuda"
    _sync(dev)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    fn()
    if cuda:
        end.record()
    _sync(dev)
    host = time.perf_counter() - t0
    return host, start.elapsed_time(end) / 1e3 if cuda else None


def device_busy_pct(fn: Callable, dev: torch.device) -> float:
    """The share of a window running ``fn()`` in which the device computes,
    from ``torch.profiler``: on a card the CUDA kernels' device time, on
    the CPU (its own device) the self time of the aten operators."""
    from torch.profiler import ProfilerActivity, profile
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    if cuda:
        busy = sum(e.device_time for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    else:
        busy = sum(e.self_cpu_time_total for e in prof.events()
                   if e.name.startswith("aten::"))
    return 100.0 * busy / wall_us


def _bbox(rng: np.random.Generator) -> np.ndarray:
    x1, x2 = sorted(rng.integers(0, 30, 2).tolist())
    y1, y2 = sorted(rng.integers(0, 30, 2).tolist())
    sel = np.zeros((30, 30), np.int8)
    sel[x1:x2 + 1, y1:y2 + 1] = 1
    return sel


def bench_reference_numpy(n_steps: int = 3000, seed: int = 0
                          ) -> Tuple[float, str]:
    """Steps/s of one env of the reference (``arcle``, where it imports),
    else of the port's NumPy oracle; returns the rate and ``"arcle"`` or
    ``"oracle"``."""
    rng = np.random.default_rng(seed)
    inp = rng.integers(0, 10, (12, 12)).astype(np.int8)
    out = rng.integers(0, 10, (12, 12)).astype(np.int8)
    try:
        from arcle.envs.o2arcenv import O2ARCv2Env as RefEnv
        from arcle.loaders import Loader
    except ImportError:
        RefEnv = None
    if RefEnv is not None:
        class OneTask(Loader):
            def get_path(self, **kw):
                return ["<mem>"]

            def parse(self, **kw):
                return [([inp], [out], [inp], [out], {"id": "bench"})]

        env = RefEnv(data_loader=OneTask(), max_trial=-1)
        opts = {"prob_index": 0, "subprob_index": 0}
        env.reset(options=opts)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            _, _, term, _, _ = env.step({"selection": _bbox(rng),
                                         "operation": int(rng.integers(0,
                                                                       35))})
            if term:
                env.reset(options=opts)
        name = "arcle"
    else:
        from ..oracle import OracleEnv
        env = OracleEnv("o2arc", max_trial=-1)
        env.reset(inp, out)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            _, _, term = env.step(_bbox(rng), int(rng.integers(0, 35)))
            if term:
                env.reset(inp, out)
        name = "oracle"
    rate = n_steps / (time.perf_counter() - t0)
    log(f"{name} numpy single-env: {rate:,.0f} steps/s")
    return rate, name


def bench_engine(batch: int, steps: int, iters: int, seed: int = 0,
                 table=None, bank=None, point_actions: bool = False,
                 device="cuda", util_out: Optional[Dict] = None) -> float:
    """Best env-steps/s of ``iters`` rollouts of ``steps`` lockstep steps at
    ``batch`` envs (after a warm-up), random bbox actions (``point_actions``:
    one pixel), auto-reset from an 8-deep pool; O2ARCv2 on
    ``SyntheticLoader(16, seed=3)`` unless ``table`` / ``bank`` are given.

    ``util_out`` receives :func:`.roofline.summarize` with the kernel's
    bytes per env-step averaged over ``BYTES_STEPS`` steps of these inputs,
    ``device_busy_pct`` over one more rollout, ``bind`` (``"host"`` below
    ``BUSY_DEVICE_PCT``, else ``"device"``), ``engine`` (``"cuda"`` or
    ``"plain"``), the best rollout's ms on both clocks (CUDA events None on
    the CPU) and the call's kernel launches."""
    from ..envs import BatchedEnv
    from ..envs.rollout import (
        random_bbox_actions, random_bbox_rollout, random_point_actions)
    from ..loaders import SyntheticLoader
    from ..ops import o2arc_table, step_kernel

    dev = _device(device)
    if table is None:
        table = o2arc_table(max_trial=-1)
    if bank is None:
        bank = SyntheticLoader(16, seed=3).bank(device=dev)
    env = BatchedEnv(table=table, bank=bank, max_trial=-1, episode_limit=100,
                     auto_reset=True, reset_pool=8)
    draw = random_point_actions if point_actions else random_bbox_actions
    state = [env.reset(torch.Generator(device=dev).manual_seed(seed), batch)]
    act_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    per_rollout = steps if dev.type == "cuda" else 0
    launches0 = step_kernel.LAUNCHES

    def rollout():
        before = step_kernel.LAUNCHES
        state[0], _ = random_bbox_rollout(env, state[0], steps, act_gen,
                                          draw)
        if step_kernel.LAUNCHES - before != per_rollout:
            raise RuntimeError(
                f"bench_engine: {step_kernel.LAUNCHES - before} kernel "
                f"launches in a rollout of {steps} steps on {dev}")

    host, _ = timed(rollout, dev)
    log(f"engine {table.name} B={batch}: first rollout {host:.2f} s")
    best_host, best_ev = float("inf"), None
    for it in range(iters):
        host, ev = timed(rollout, dev)
        log(f"iter {it}: {batch * steps / host:,.0f} env-steps/s "
            f"({host * 1e3:.1f} ms for {batch}x{steps}, host clock"
            + (f"; {ev * 1e3:.1f} ms between CUDA events)" if ev else ")"))
        if host < best_host:
            best_host, best_ev = host, ev
    best = batch * steps / best_host
    if util_out is not None:
        H, W = state[0].env.hw
        bs, nbytes = state[0], 0
        n = min(steps, BYTES_STEPS)
        for _ in range(n):
            act = draw(act_gen, batch, table.n_ops, H, W, dev)
            nbytes += roofline.step_kernel_bytes(bs.env, act, table)
            bs = env.step(bs, act)[0]
        state[0] = bs
        busy = device_busy_pct(rollout, dev)
        util_out.update(roofline.summarize(
            best, batch, steps, None, nbytes / (n * batch),
            roofline.device_peaks(dev)))
        util_out.update(
            device_busy_pct=round(busy, 2),
            engine="cuda" if dev.type == "cuda" else "plain",
            bind="host" if busy < BUSY_DEVICE_PCT else "device",
            rollout_ms={"host": round(best_host * 1e3, 3),
                        "events": best_ev and round(best_ev * 1e3, 3)},
            launches=step_kernel.LAUNCHES - launches0)
        log(f"roofline: {util_out}")
    return best


def bench_single_env_adapter(n_steps: Optional[int] = None, seed: int = 0,
                             backend: str = "auto", device="cuda") -> float:
    """Steps/s of ``RawARCEnv`` on the bundled Mini-ARC sample, stepped one
    action at a time (``BASELINE.json`` config 1 as a user runs it):
    ``backend="auto"`` steps the kernel at B=1 on ``device``, ``"native"``
    the C++ engine on the host.  ``n_steps`` defaults to
    ``ADAPTER_STEPS``."""
    from ..envs.gym_compat import RawARCEnv
    from ..loaders import MiniARCLoader
    from ..ops import step_kernel

    n_steps = ADAPTER_STEPS if n_steps is None else n_steps
    dev = _device(device)
    rng = np.random.default_rng(seed)
    env = RawARCEnv(data_loader=MiniARCLoader(), max_trial=-1,
                    backend=backend, device=dev)
    opts = {"prob_index": 0, "subprob_index": 0}
    env.reset(seed=seed, options=opts)
    n_ops = len(env.operations)
    before = step_kernel.LAUNCHES
    t0 = time.perf_counter()
    for _ in range(n_steps):
        _, _, term, _, _ = env.step(
            {"selection": _bbox(rng), "operation": int(rng.integers(0,
                                                                    n_ops))})
        if term:
            env.reset(options=opts)
    rate = n_steps / (time.perf_counter() - t0)
    want = n_steps if backend == "auto" and dev.type == "cuda" else 0
    if step_kernel.LAUNCHES - before != want:
        raise RuntimeError(f"single-env adapter ({backend}): "
                           f"{step_kernel.LAUNCHES - before} kernel launches "
                           f"for {n_steps} steps")
    log(f"single-env gym adapter ({backend}, {dev}): {rate:,.0f} steps/s")
    return rate


def corpus_bank(device) -> Tuple[TaskBank, int]:
    """The configurations' task bank on ``device``: a ``write_corpus``
    corpus of ``CORPUS`` tasks, written to a temporary directory and baked
    by ``ARCLoader``; returns the bank and its pair count."""
    from ..loaders import ARCLoader
    from ..loaders.synthetic import write_corpus

    n_tasks, n_train, n_test = CORPUS
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        n_pairs = write_corpus(td, n_tasks=n_tasks, n_train=n_train,
                               n_test=n_test)
        bank = ARCLoader(root=td).bank(device=device)
        log(f"{n_tasks}-task corpus ({n_pairs} pairs) written and baked in "
            f"{time.perf_counter() - t0:.1f} s")
    return bank, n_pairs


def bench_baseline_configs(steps: int, device="cuda") -> Dict:
    """``BASELINE.json``'s configurations 1-3 -- Raw on Mini-ARC at 1 env
    (the card and native), Raw at 256 envs and ARC with point actions at
    1024 envs on a ``write_corpus`` corpus -- and the cost of
    ``BatchedEnv.reset`` of ``RESET_ENVS`` envs on that corpus: the first,
    cold call and the best of 3 more.  ``"roofline"`` holds the two
    engine configurations' roofline blocks."""
    from ..envs import BatchedEnv
    from ..ops import arc_table, o2arc_table, raw_table

    dev = _device(device)
    out = {"raw_miniarc_1env": round(bench_single_env_adapter(device=dev)),
           "raw_miniarc_1env_native": round(bench_single_env_adapter(
               backend="native", device=dev))}
    arc_bank, n_pairs = corpus_bank(dev)
    util = {"raw_arc_256env": {}, "arc_point_1024env": {}}
    raw_envs, point_envs = CONFIG_ENVS
    out["raw_arc_256env"] = round(bench_engine(
        raw_envs, steps, 2, table=raw_table(max_trial=-1), bank=arc_bank,
        device=dev, util_out=util["raw_arc_256env"]))
    out["arc_point_1024env"] = round(bench_engine(
        point_envs, steps, 2, table=arc_table(max_trial=-1), bank=arc_bank,
        point_actions=True, device=dev, util_out=util["arc_point_1024env"]))

    env = BatchedEnv(table=o2arc_table(max_trial=-1), bank=arc_bank,
                     max_trial=-1, episode_limit=100, auto_reset=True)
    gen = torch.Generator(device=dev)
    seconds = []
    for i in range(4):
        gen.manual_seed(i)
        seconds.append(timed(lambda: env.reset(gen, RESET_ENVS), dev)[0])
    out["reset_4096env_3200pair_ms"] = round(min(seconds[1:]) * 1e3, 1)
    out["reset_4096env_eager_ms"] = round(seconds[0] * 1e3, 1)
    out["corpus_pairs"] = n_pairs
    out["roofline"] = util
    log(f"baseline configs: {out}")
    return out


def train_config(device: str, n_envs: int, iterations: int):
    """``bench.py::bench_train_loop``'s configuration: O2ARCv2 with CropGrid
    at op 33, max_trial=127, episode_limit=100, dense reward,
    augmentation, an 8-deep reset pool, SyntheticLoader(32, seed=7), the
    full-width FCPolicy (``TRAIN_HIDDEN``) and PPOConfig() (one full-batch
    update)."""
    from ..utils import RunConfig, EnvConfig
    return RunConfig(seed=0, algo="ppo", model="mlp",
                     total_iterations=iterations, checkpoint_every=0,
                     device=device,
                     env=EnvConfig(family="o2arc_crop33", max_trial=127,
                                   episode_limit=100, n_envs=n_envs,
                                   dataset="synthetic", n_synthetic_tasks=32,
                                   dense_reward=True, augment=True,
                                   reset_pool=8),
                     mlp_hidden=TRAIN_HIDDEN)


def bench_train_loop(batch: int, steps: int, iters: int = 3,
                     dtype: str = "float32", device="cuda",
                     util_out: Optional[Dict] = None) -> float:
    """Env-steps/s including the learner: ``batch`` envs of
    :func:`train_config` feeding the PPO learner, ``steps`` rollout steps
    per iteration (``setup_ppo``, then ``ppo_iteration``: ``rollout``,
    ``batch_from_trajectory``, ``train_step``); the best of ``iters``
    iterations after a warm-up, on the host clock ending in a synchronize.
    ``dtype`` is the MLP torso's (``"float32"`` with TF32 off, checked, or
    ``"bfloat16"``).  ``util_out`` receives the best iteration's rollout /
    update split (CUDA events on a card) and :func:`.roofline.summarize`
    with the warm-up's FLOPs, ``mfu_pct`` against the peak of ``dtype``."""
    import dataclasses

    from ..ops import step_kernel
    from ..training.train import ppo_iteration, setup_ppo

    dev = _device(device)
    if dtype == "float32" and (torch.backends.cuda.matmul.allow_tf32 or
                               torch.get_float32_matmul_precision()
                               != "highest"):
        raise RuntimeError("bench_train_loop: float32 matmuls are not full "
                           "float32 (TF32 is on)")
    cfg = dataclasses.replace(train_config(str(dev), batch, iters + 1),
                              mlp_dtype=dtype)
    run = setup_ppo(cfg)
    run.n_steps = steps
    cost = roofline.cost_from_flop_counter(ppo_iteration, run)   # warm-up
    best, split = float("inf"), None
    per_iteration = steps if dev.type == "cuda" else 0
    for _ in range(iters):
        out, before = [], step_kernel.LAUNCHES
        host, _ = timed(lambda: out.append(ppo_iteration(run)), dev)
        if step_kernel.LAUNCHES - before != per_iteration:
            raise RuntimeError(
                f"bench_train_loop: {step_kernel.LAUNCHES - before} kernel "
                f"launches in an iteration of {steps} steps on {dev}")
        loss = float(out[0][1]["total_loss"])
        if not math.isfinite(loss):
            raise RuntimeError(f"bench_train_loop: loss {loss}")
        if host < best:
            best, split = host, out[0][2].ms()
    rate = batch * steps / best
    log(f"ppo train loop ({dtype}): {best * 1e3:.1f} ms/iter -> "
        f"{rate:,.0f} env-steps/s incl. learner (rollout {split[0]:.1f} + "
        f"update {split[1]:.1f} ms)")
    if util_out is not None:
        util_out.update(ms_per_iter=round(best * 1e3, 3),
                        rollout_ms=round(split[0], 3),
                        update_ms=round(split[1], 3), dtype=dtype)
        util_out.update(roofline.summarize(
            rate, batch, steps, cost, None, roofline.device_peaks(dev),
            MFU_PEAK[dtype]))
    return rate


def scaling_rank(batch_per_rank: str, steps: str) -> None:
    """One rank of :func:`bench_scaling` (started by ``parallel.launch``):
    the global batch of ``batch_per_rank`` x world size O2ARCv2 envs is
    reset alike on every rank, each rank steps its block
    (``shard_global_leading``) and prints ``SCALING <seconds>``, its best
    of 2 rollouts after a warm-up, each begun after a barrier."""
    import torch.distributed as dist

    from ..envs import BatchedEnv
    from ..envs.rollout import random_bbox_rollout
    from ..loaders import SyntheticLoader
    from ..ops import o2arc_table
    from ..parallel import make_mesh
    from ..parallel.multihost import shard_global_leading

    batch_per_rank, steps = int(batch_per_rank), int(steps)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    env = BatchedEnv(table=o2arc_table(max_trial=-1),
                     bank=SyntheticLoader(16, seed=3).bank(device=dev),
                     max_trial=-1, episode_limit=100, auto_reset=True,
                     reset_pool=8)
    n, rank = dist.get_world_size(), dist.get_rank()
    bs = env.reset(torch.Generator(device=dev).manual_seed(0),
                   batch_per_rank * n)
    bs = [shard_global_leading(bs, make_mesh(device_type=dev.type), "data")]
    gen = torch.Generator(device=dev).manual_seed(1 + rank)

    def run():
        bs[0], _ = random_bbox_rollout(env, bs[0], steps, gen)

    run()
    best = float("inf")
    for _ in range(2):
        dist.barrier()
        best = min(best, timed(run, dev)[0])
    print(f"SCALING {best!r}", flush=True)


def bench_scaling(batch_per_rank: int, steps: int,
                  world_sizes: Sequence[int], device="cuda"
                  ) -> Dict[int, Tuple[float, float]]:
    """The engine on each of ``world_sizes`` ranks (NCCL with one rank per
    card, or Gloo on the CPU), ``batch_per_rank`` envs each: returns
    ``{n: (env-steps/s of all ranks, efficiency % per rank against the
    first world size)}``.  The rate counts the slowest rank's time."""
    from ..parallel.launch import spawn

    dev = _device(device)
    if dev.type == "cuda" and max(world_sizes) > torch.cuda.device_count():
        raise ValueError(f"bench_scaling: {max(world_sizes)} ranks for "
                         f"{torch.cuda.device_count()} cards (one rank per "
                         "card)")
    results, base = {}, None
    for n in world_sizes:
        outs = spawn("arcle_tpu_torch.benchmarks.bench:scaling_rank", n,
                     dev.type, (batch_per_rank, steps), timeout_s=600.0)
        seconds = [float(line.split()[1]) for o in outs
                   for line in o.splitlines() if line.startswith("SCALING ")]
        if len(seconds) != n:
            raise RuntimeError(f"bench_scaling: {len(seconds)} of {n} ranks "
                               "reported")
        rate = batch_per_rank * n * steps / max(seconds)
        base = base or rate / n
        results[n] = (rate, rate / n / base * 100.0)
        log(f"ranks={n} ({dev.type}): {rate:,.0f} env-steps/s, "
            f"{rate / n:,.0f} per rank, efficiency {results[n][1]:.1f}%")
    return results
