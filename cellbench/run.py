"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 cellbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's program from the seed and warms up every shape it
uses (``setup_s``); the window then runs the cell's unit of work until
``--seconds`` have passed and the card has finished it; after the window
the peak memory is read, the program's state is freed and the plain
reference judges what the timed path produced.  ``--trace 1`` runs the
same window under ``torch.profiler`` and reports the per-layer metrics in
place of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``busy_s`` / ``window_s``, and ``breakdown``), and ``checks``: each
number compared with its limit, also printed as the last lines of
standard error.  Without as many CUDA cards as the cell asks for, the run
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    # run as a script: import the benchmark and the port from the checkout
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _here]
    sys.path.insert(0, str(_here.parent))

from cellbench import harness as H  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 cellbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda") -> int:
    """One run.  ``device`` is for the CPU tests alone; the command line
    always runs on the card."""
    args = parse_args(argv)
    H.set_cache_dirs()
    spec = H.load_cell(args.workload)
    import torch
    if device == "cuda":
        H.require_cards(int(spec["cell"]["chips"]))
    from cellbench.reference.numerics import full_float32
    full_float32()
    dev = torch.device(device)
    drv = H.driver(spec["traffic"]["driver"])
    trace = bool(args.trace)
    spans = H.Spans(trace)

    cell = drv.setup(spec, args.seed, dev, spans)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = H.process_age_s()

    tr = H.Trace(dev) if trace else None
    if tr is not None:
        tr.start()
    t0 = time.perf_counter()
    units = 0
    while True:
        cell.unit(units)
        units += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    if tr is not None:
        tr.stop()

    cell.after_window()
    memory_peak = int(torch.cuda.max_memory_allocated()) \
        if dev.type == "cuda" else 0
    if tr is not None:
        busy_s, gaps = tr.busy_idle(window_s)
        ctx = cell.layer_context(units, window_s)
        phases = cell.phases(tr)
    found = H.loaded_banned()
    if found:
        print(f"cellbench: loaded {found}, which the benchmark never loads",
              file=sys.stderr)
        return 3
    cell.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = cell.check()
    # the cell's limits name the numbers it compares
    checks = [(k, float(numbers[k]), float(lim))
              for k, lim in spec["limits"].items()]
    cell.failed += sum(not H.finite(v) for _, v, _ in checks)
    correct = all(H.finite(v) and v <= lim for _, v, lim in checks)

    metrics = {}
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev)
                  if dev.type == "cuda" else "cpu",
                  "count": int(spec["cell"]["chips"]),
                  "memory_peak_bytes": memory_peak,
                  "power_limit_w": H.power_limit_w()
                  if dev.type == "cuda" else None}
    out = {}
    if not trace:
        values = cell.end_to_end(units, window_s)
        values["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx.update(trace=tr, busy_s=busy_s, window_s=window_s, spans=spans,
                   card=device_out["kind"],
                   bytes_per_env_step=getattr(cell, "bytes_per_env_step",
                                              None))
        for m in spec["per_layer"]:
            v = H.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_out.update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = {
            "device_ops": tr.device_ops(),
            "idle_gaps": H.label_gaps(gaps, phases)}
    result = {"correct": bool(correct), "attempted": int(units),
              "failed": int(cell.failed), "metrics": metrics,
              "device": device_out}
    result.update(out)
    result["checks"] = {k: {"value": v if H.finite(v) else None,
                            "limit": lim} for k, v, lim in checks}
    found = H.loaded_banned()
    if found:
        print(f"cellbench: loaded {found}, which the benchmark never loads",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    H.print_checks(checks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
