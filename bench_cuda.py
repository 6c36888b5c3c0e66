#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: O2ARCv2 env-steps/s at 4096
lockstep envs on one card.

Counterpart of ``bench.py``, over ``arcle_tpu_torch`` (functions in
``arcle_tpu_torch/benchmarks/bench.py``).  The rollout is the training hot
path's: every step draws a random bbox action per env on the device and
steps the full 35-op transition through the CUDA step kernel, with
auto-reset from an 8-deep pool.

    python3 bench_cuda.py                   # everything, on the card
    python3 bench_cuda.py --scaling         # 1..n ranks, one per card (NCCL)
    python3 bench_cuda.py --device cpu --batch 8 --steps 3 --iters 1 \\
        --ref-steps 20 --headline-only      # the plain step on the CPU

Prints ONE JSON line: ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``roofline``, ``configs``,
``ppo_train_loop_steps_per_s``), plus ``device`` (the card's name and
power limit), ``baseline`` (which single-env baseline ran: ``"arcle"``,
the reference where it imports, or ``"oracle"``, the port's NumPy copy;
``"skipped"`` with ``--skip-ref``) and ``ppo_train_loop`` (the train
loop's split and FLOP share).  Without CUDA it exits with code 2 unless
``--device cpu`` is given; a failing part raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from arcle_tpu_torch.benchmarks import bench, roofline


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ref-steps", type=int, default=3000)
    ap.add_argument("--skip-ref", action="store_true")
    ap.add_argument("--headline-only", action="store_true",
                    help="skip the BASELINE configs 1-3 and the train loop")
    ap.add_argument("--scaling", action="store_true",
                    help="the engine on 1..n ranks instead of the "
                         "single-card benchmark")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32", help="the train loop's MLP torso")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The benchmark's result for ``args`` (see the module)."""
    peaks = roofline.device_peaks(args.device)
    device = {"name": peaks["name"], "power_limit_w": peaks["power_limit_w"]}
    if args.scaling:
        sizes = [n for n in (1, 2, 4, 8) if n <= torch.cuda.device_count()] \
            if args.device == "cuda" else [1, 2]
        results = bench.bench_scaling(max(args.batch // 8, 64),
                                      min(args.steps, 20), sizes,
                                      args.device)
        n = max(results)
        rate, eff = results[n]
        return {"metric": f"O2ARCv2 sharded env-steps/s @ {n} ranks",
                "value": round(rate), "unit": "env-steps/s",
                "vs_baseline": round(eff, 1), "device": device}

    if args.skip_ref:
        ref_rate, baseline = None, "skipped"
    else:
        ref_rate, baseline = bench.bench_reference_numpy(args.ref_steps)
    util = {}
    rate = bench.bench_engine(args.batch, args.steps, args.iters,
                              device=args.device, util_out=util)
    result = {
        "metric": f"O2ARCv2 env-steps/s @ {args.batch} lockstep envs "
                  f"(random bbox actions, auto-reset)",
        "value": round(rate),
        "unit": "env-steps/s",
        "vs_baseline": round(rate / ref_rate, 2) if ref_rate else None,
        "baseline": baseline,
        "roofline": util,
        "device": device,
    }
    if not args.headline_only:
        result["configs"] = bench.bench_baseline_configs(
            min(args.steps, 100), args.device)
        train = {}
        result["ppo_train_loop_steps_per_s"] = round(bench.bench_train_loop(
            args.batch, args.steps, 3, args.dtype, args.device,
            util_out=train))
        result["ppo_train_loop"] = train
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_cuda: CUDA is not available (pass --device cpu to run "
              "the plain step on the CPU)", file=sys.stderr)
        return 2
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
