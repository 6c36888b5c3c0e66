"""Metric logging and throughput accounting.

Counterpart of ``arcle_tpu/utils/metrics.py``: a dependency-free metric
logger (JSONL + stderr) with the reference's wandb metric names
(train.py:130-150), env-steps/s with a host readback as the barrier, and a
``torch.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, Iterator, Optional

import torch


class MetricLogger:
    """wandb-schema-compatible metric sink writing JSONL; plug a wandb run
    in through ``backend`` if one is available."""

    def __init__(self, path: Optional[str] = None, backend=None):
        self.path = path
        self.backend = backend
        self._fp = open(path, "a") if path else None
        self.t0 = time.time()

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None

    def meta(self, info: Dict) -> None:
        """One provenance header line (``{"meta": ...}``, no
        ``iteration`` key, so curve readers skip it)."""
        if self._fp:
            self._fp.write(json.dumps({"meta": info,
                                       "ts": time.time()}) + "\n")
            self._fp.flush()

    def log(self, step: int, metrics: Dict) -> None:
        clean = {}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu()
                v = v.item() if v.ndim == 0 else v.tolist()
            clean[k] = v
        clean["iteration"] = step
        clean["wall_time"] = time.time() - self.t0
        if self._fp:
            self._fp.write(json.dumps(clean) + "\n")
            self._fp.flush()
        if self.backend is not None:
            self.backend.log(clean, step=step)
        else:
            brief = {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in clean.items() if not isinstance(v, list)}
            print(f"[{step}] {brief}", file=sys.stderr, flush=True)


class Throughput:
    """env-steps/s over the window since the previous tick, with a read of
    a device scalar as the completion barrier."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._last = time.perf_counter()

    def tick(self, n_env_steps: int,
             barrier_scalar: Optional[torch.Tensor] = None) -> float:
        """The first window includes the warm-up."""
        if barrier_scalar is not None:
            float(barrier_scalar)
        now = time.perf_counter()
        rate = n_env_steps / max(now - self._last, 1e-9)
        self._last = now
        return rate


@contextlib.contextmanager
def profile_trace(logdir: str = "./torch-trace") -> Iterator:
    """``torch.profiler`` trace context: host activity, and the device's
    where CUDA is available.  Yields the profiler (``key_averages()`` and
    ``events()`` are readable after the block); on exit a Chrome trace
    ``trace_<pid>_<ns>.json`` lies under ``logdir`` (open it in Perfetto or
    ``chrome://tracing``)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
