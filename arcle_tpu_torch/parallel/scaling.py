"""Scaling evidence for the data-parallel learner.

Counterpart of ``arcle_tpu/parallel/scaling.py``.  Three layers, from
measured to modelled:

1. :func:`measure_ppo_scaling` times the whole PPO iteration (rollout
   through the batched env and the policy, then the data-parallel update
   with its gradient all-reduce) on ``d`` ranks of one host, at a fixed
   number of envs per rank (weak scaling): NCCL on the card while ``d``
   does not exceed the cards, Gloo on the CPU otherwise.  On one host the
   ranks share its cores (and, on the card, one card cannot host two NCCL
   ranks), so the efficiency it reports measures host contention, not an
   interconnect.
2. :func:`fit_allreduce` fits the ring all-reduce cost model ``T(d) =
   t_comp + t_ring * (d - 1) / d`` to that sweep.
3. :func:`project_multihost` is a model: the only cross-host traffic of
   the design is the gradient all-reduce, ``2 (N - 1) / N * G`` bytes per
   host per update, against an update period the caller measured.
   :func:`validate_allreduce_model` checks the model's linear-in-bytes
   structure on a real 2-process Gloo all-reduce.

``DCN_BW`` is the projection's assumed per-host network rate (a 50 Gb/s
NIC); :func:`scaling_report` also shows 1 and 25 GB/s.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, Sequence

import numpy as np

from .launch import free_port, run_commands, spawn

DCN_BW = 6.25e9      # bytes/s per host, 50 Gb/s NIC


def _scaling_rank(per_device_envs: str, T: str, iters: str,
                  n_layer: str) -> None:
    """One rank of :func:`measure_ppo_scaling`: the answer-given stack
    (5x5, the GPT policy, 64 tasks, ``episode_limit=10``), this rank's
    ``per_device_envs`` envs, a warm-up and ``iters`` timed iterations.
    Rank 0 prints ``SCALING {...}`` with the slowest rank's best time."""
    import torch
    import torch.distributed as dist

    from ..benchmarks.answer_given import (
        answer_given_agent, answer_given_env, make_policy,
    )
    from ..training.ppo import PPOConfig, make_optimizer
    from ..training.train import PPORun, ppo_iteration
    from ..utils.config import RunConfig
    from .mesh import shard_block

    per, T, iters = int(per_device_envs), int(T), int(iters)
    n, rank = dist.get_world_size(), dist.get_rank()
    cuda = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    cfg = PPOConfig(n_epochs=1, n_minibatches=1)
    agent = answer_given_agent(make_policy(h=5, w=5, n_layer=int(n_layer)))
    env = answer_given_env(n_tasks=64, seed=0, episode_limit=10, device=dev)
    bs = shard_block(env.reset(torch.Generator(device=dev).manual_seed(0),
                               per * n), n, rank)
    params = agent.init_fn(torch.Generator().manual_seed(1)).to(dev)
    run = PPORun(cfg=RunConfig(ppo=cfg, device=dev.type), env=env,
                 agent=agent, params=params,
                 opt=make_optimizer(params, cfg), generator=bs.generator,
                 bs=bs, n_steps=T, group=dist.group.WORLD)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ppo_iteration(run)                                  # warm-up
    best = float("inf")
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        _, stats, _ = ppo_iteration(run)
        float(stats["total_loss"])
        best = min(best, time.perf_counter() - t0)
    slowest = torch.tensor([best], dtype=torch.float64, device=dev)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    n_params = sum(p.numel() for p in params.parameters())
    if rank == 0:
        name = torch.cuda.get_device_name(dev) if cuda else "cpu"
        print("SCALING " + json.dumps({
            "iter_s": float(slowest), "n_params": n_params,
            "backend": dist.get_backend(), "device": name}), flush=True)


def measure_ppo_scaling(device_counts: Sequence[int] = (1, 2, 4, 8),
                        per_device_envs: int = 8, T: int = 8,
                        iters: int = 3, n_layer: int = 2,
                        budget_s: Optional[float] = None,
                        device: str = "cuda"):
    """Weak-scaling sweep of the whole PPO iteration over ``d`` ranks for
    each count.  Returns ``[{devices, iter_s, steps_per_s, per_device,
    efficiency, n_params, backend, device}]``.

    ``device="cuda"`` runs NCCL ranks for counts up to
    ``torch.cuda.device_count()`` and Gloo ranks on the CPU beyond;
    ``"cpu"`` runs Gloo throughout.  ``budget_s`` bounds the sweep's wall
    clock: the next count is skipped when the last count's seconds would
    overrun it."""
    import torch

    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    rows, base = [], None
    t_start, t_last = time.perf_counter(), 0.0
    for d in device_counts:
        if budget_s is not None and rows and \
                time.perf_counter() - t_start + t_last > budget_s:
            print(f"scaling: budget {budget_s:.0f}s exhausted after "
                  f"devices={rows[-1]['devices']}; skipping "
                  f"{[x for x in device_counts if x > rows[-1]['devices']]}")
            break
        t0 = time.perf_counter()
        outs = spawn("arcle_tpu_torch.parallel.scaling:_scaling_rank", d,
                     "cuda" if d <= n_cards else "cpu",
                     (per_device_envs, T, iters, n_layer), timeout_s=900.0)
        rec = next(json.loads(line[len("SCALING "):])
                   for line in outs[0].splitlines()
                   if line.startswith("SCALING "))
        rate = per_device_envs * d * T / rec["iter_s"]
        if base is None:
            base = rate / d
        rows.append({"devices": d, "iter_s": rec["iter_s"],
                     "steps_per_s": rate, "per_device": rate / d,
                     "efficiency": rate / d / base,
                     "n_params": rec["n_params"], "backend": rec["backend"],
                     "device": rec["device"]})
        t_last = time.perf_counter() - t0
    return rows


def fit_allreduce(rows):
    """Least-squares fit of T(d) = t_comp + t_ring*(d-1)/d to the sweep.
    Under weak scaling t_comp is the per-step compute at fixed per-device
    work; t_ring upper-bounds collective (+ host contention) cost."""
    d = np.array([r["devices"] for r in rows], dtype=np.float64)
    t = np.array([r["iter_s"] for r in rows], dtype=np.float64)
    X = np.stack([np.ones_like(d), (d - 1.0) / d], axis=1)
    coef, *_ = np.linalg.lstsq(X, t, rcond=None)
    t_comp, t_ring = float(coef[0]), float(coef[1])
    if t_comp < 0.0:
        # contention-dominated sweep (the ranks oversubscribe the host's
        # cores): pin compute to the single-rank measurement and
        # attribute the rest to the ring term
        t_comp = float(t[d == 1.0][0]) if np.any(d == 1.0) else 0.0
        r = (d - 1.0) / d
        t_ring = float(np.sum(r * (t - t_comp)) / np.sum(r * r))
    return {"t_comp_s": t_comp, "t_ring_s": max(t_ring, 0.0)}


def project_multihost(n_params: int, update_period_s: float,
                      hosts: Sequence[int] = (2, 4, 8, 16),
                      bw: float = DCN_BW):
    """Modelled N-host DP efficiency: the only cross-host traffic is the
    gradient ring all-reduce (2*(N-1)/N * 4*n_params bytes per host per
    update) over the network; env stepping crosses no host boundary."""
    g_bytes = 4.0 * n_params
    out = []
    for n in hosts:
        t_comm = 2.0 * (n - 1) / n * g_bytes / bw
        eff = update_period_s / (update_period_s + t_comm)
        out.append({"hosts": n, "grad_mb": g_bytes / 1e6,
                    "t_comm_ms": t_comm * 1e3, "efficiency": eff})
    return out


def validate_allreduce_model(n_params: int, probe_mb: float = 1.0,
                             timeout_s: float = 300.0) -> dict:
    """Predicted-vs-measured all-reduce on a real collective.

    Two processes of :mod:`.psum_worker` (Gloo over the host) time an
    all-reduce at two probe sizes and at the gradient's size (the workers
    check every element of every sum).  The probes fit the ring model
    ``t = t_lat + 2*(N-1)/N * G / bw`` (``N = 2``), which then predicts
    the gradient-size time out of sample.  The absolute Gloo/TCP rate says
    nothing about a real network.  A worker that fails raises."""
    grad_mb = 4.0 * n_params / 1e6
    probe2_mb = 4.0 * probe_mb
    sizes = f"{probe_mb},{probe2_mb},{grad_mb:.6f}"
    port = str(free_port())
    outs = run_commands(
        [[sys.executable, "-m", "arcle_tpu_torch.parallel.psum_worker",
          str(pid), "2", port, sizes] for pid in range(2)], timeout_s)
    times = next(json.loads(line[len("PSUM_TIMES "):])
                 for line in outs[0].splitlines()
                 if line.startswith("PSUM_TIMES "))
    t1, t2 = times[str(probe_mb)], times[str(probe2_mb)]
    t_grad = times[f"{grad_mb:.6f}"]
    # N = 2: t = t_lat + G / bw.  Two probes pin (t_lat, bw); the
    # gradient-size time is then an out-of-sample prediction
    bw_fit = (probe2_mb - probe_mb) * 1e6 / max(t2 - t1, 1e-9)
    t_lat = max(t1 - probe_mb * 1e6 / bw_fit, 0.0)
    predicted = t_lat + grad_mb * 1e6 / bw_fit
    return {"probe_mb": [probe_mb, probe2_mb], "probe_s": [t1, t2],
            "grad_mb": grad_mb, "measured_s": t_grad,
            "fitted_bw_gbps": bw_fit / 1e9,
            "fitted_latency_ms": t_lat * 1e3, "predicted_s": predicted,
            "ratio_pred_over_meas": predicted / t_grad}


def flagship_n_params() -> int:
    """Parameter count of the port's flagship ``GPTPolicy(GPTConfig())``
    (8 layers, 16 heads, width 128): the gradient the projection moves."""
    from ..models.gpt import GPTConfig, GPTPolicy
    return sum(p.numel() for p in GPTPolicy(GPTConfig()).parameters())


def scaling_report(device_counts=(1, 2, 4, 8), per_device_envs: int = 8,
                   T: int = 8, n_layer: int = 2,
                   budget_s: Optional[float] = None, *,
                   update_period_s: float, period_source: str,
                   device: str = "cuda") -> dict:
    """Measured sweep, fit, collective check and the modelled multi-host
    projection; prints each.  ``update_period_s`` is a PPO update period
    the caller measured, and ``period_source`` says where (the device and
    the run); the projection is printed beside it."""
    rows = measure_ppo_scaling(device_counts, per_device_envs, T,
                               n_layer=n_layer, budget_s=budget_s,
                               device=device)
    fit = (fit_allreduce(rows) if len(rows) >= 2
           else {"t_comp_s": rows[0]["iter_s"] if rows else 0.0,
                 "t_ring_s": None})
    n_params = flagship_n_params()
    proj = project_multihost(n_params, update_period_s)
    # the 6.25 GB/s constant is a NIC spec, not a measurement
    sens = []
    for bw in (1e9, DCN_BW, 25e9):
        p = project_multihost(n_params, update_period_s, bw=bw)
        sens.append({"bw_gbps": bw / 1e9,
                     "worst_eff": min(x["efficiency"] for x in p),
                     "eff_16_hosts": p[-1]["efficiency"]})
    val = validate_allreduce_model(n_params)

    print(f"scaling: whole PPO iteration (rollout + data-parallel update), "
          f"weak scaling, {per_device_envs} envs/rank x T={T} (ranks on one "
          "host share its cores: the efficiency measures contention, not "
          "an interconnect):")
    for r in rows:
        print(f"  ranks={r['devices']} ({r['backend']}, {r['device']}): "
              f"{r['steps_per_s']:,.0f} steps/s total, "
              f"{r['per_device']:,.0f}/rank, efficiency "
              f"{r['efficiency'] * 100:.1f}%")
    if fit["t_ring_s"] is None:
        print("scaling fit: skipped - one rank count only (no multi-rank "
              "point to fit the ring term against)")
    else:
        print(f"scaling fit T(d)=t_comp+t_ring*(d-1)/d: "
              f"t_comp={fit['t_comp_s'] * 1e3:.1f}ms "
              f"t_ring<={fit['t_ring_s'] * 1e3:.1f}ms "
              "(upper bound: includes host core contention)")
    print(f"model projection (not a measurement): grad all-reduce "
          f"{proj[0]['grad_mb']:.1f} MB/update ({n_params:,} params) over an "
          f"assumed {DCN_BW / 1e9:.2f} GB/s per host vs an update period of "
          f"{update_period_s * 1e3:.1f} ms measured on {period_source}:")
    for p in proj:
        print(f"  hosts={p['hosts']}: t_comm={p['t_comm_ms']:.2f}ms, "
              f"modelled efficiency {p['efficiency'] * 100:.2f}%")
    print("model sensitivity to the assumed network rate "
          "(worst-host / 16-host efficiency):")
    for s in sens:
        print(f"  bw={s['bw_gbps']:.2f} GB/s: "
              f"{s['worst_eff'] * 100:.2f}% / {s['eff_16_hosts'] * 100:.2f}%")
    print(f"collective check (2-process Gloo all-reduce, isolated): probes "
          f"{val['probe_mb']} MB -> bw={val['fitted_bw_gbps']:.2f} GB/s + "
          f"{val['fitted_latency_ms']:.2f} ms latency; the model predicts "
          f"{val['predicted_s'] * 1e3:.1f} ms for the {val['grad_mb']:.1f} "
          f"MB gradient, measured {val['measured_s'] * 1e3:.1f} ms "
          f"(pred/meas = {val['ratio_pred_over_meas']:.2f})")
    worst = min(p["efficiency"] for p in proj)
    return {"sweep": rows, "fit": fit, "n_params": n_params,
            "update_period_s": update_period_s,
            "period_source": period_source, "projection": proj,
            "bw_sensitivity": sens, "collective_validation": val,
            "meets_target": worst >= 0.80}
