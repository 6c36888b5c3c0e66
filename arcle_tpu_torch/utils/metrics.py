"""Metric logging, throughput accounting and the program's spans.

Counterpart of ``arcle_tpu/utils/metrics.py``: a dependency-free metric
logger (JSONL + stderr) with the reference's wandb metric names
(train.py:130-150), env-steps/s with a host readback as the barrier, and a
``torch.profiler`` trace context.  ``TRACE`` records the port's spans at
its layer boundaries (iteration, rollout, policy, env.step, step_kernel,
auto_reset, learner_batch, update, minibatch, and the garbage collector's
passes) while a ``torch.profiler`` trace runs or between its ``start()``
and ``stop()``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler


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


class _NullSpan:
    """The span of a recorder that is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("rec", "name", "entry")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        # build the record before it is appended: a collector pass that the
        # allocation may start records its own span in between
        self.entry = [self.name, time.perf_counter_ns(), 0,
                      stack[-1] if stack else -1]
        rec.spans.append(self.entry)
        stack.append(len(rec.spans) - 1)
        return None

    def __exit__(self, *exc):
        self.entry[2] = time.perf_counter_ns()
        if self.rec._stack:
            self.rec._stack.pop()
        return False


class SpanRecorder:
    """The program's spans, kept in memory: ``spans`` holds one
    ``[name, start ns, end ns, parent index]`` per span in the order they
    opened, stamped with ``time.perf_counter_ns()``; a parent index of -1
    marks a root.  ``clock`` is a ``(perf_counter_ns, time_ns)`` pair taken
    at ``start()``, which maps the spans onto the Unix-ns clock of a
    ``torch.profiler`` trace.

    The recorder records between ``start()`` and ``stop()``, and while a
    ``torch.profiler`` trace runs: the first span inside the trace starts
    it, the first after the trace stops it.  Off, ``span()`` makes two
    attribute tests and returns one shared null context.  Recording reads
    no device value and never synchronises.  While it records, each pass
    of the garbage collector is a ``gc`` span."""

    def __init__(self):
        self.on = False
        self.spans: List[list] = []
        self.clock: Optional[Tuple[int, int]] = None
        self._stack: List[int] = []
        self._following = False
        self._gc_span: Optional[_Span] = None
        self._gc_hook = self._on_gc

    def start(self) -> None:
        """Forget what was recorded and record from now on."""
        self.spans, self._stack = [], []
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        self.clock = ((a + b) // 2, unix)
        if self._gc_hook not in gc.callbacks:
            gc.callbacks.append(self._gc_hook)
        self.on = True

    def stop(self) -> None:
        """Stop recording; ``spans`` stay readable until the next start."""
        self.on = self._following = False
        if self._gc_hook in gc.callbacks:
            gc.callbacks.remove(self._gc_hook)

    def span(self, name: str):
        """A context manager that records the block as span ``name``."""
        if not self.on:
            if not _profiler._is_profiler_enabled:
                return _NULL_SPAN
            self.start()
            self._following = True
        elif self._following and not _profiler._is_profiler_enabled:
            self.stop()
            return _NULL_SPAN
        return _Span(self, name)

    def to_unix_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` stamp on the Unix-ns clock."""
        return t - self.clock[0] + self.clock[1]

    def _on_gc(self, phase: str, info: Dict) -> None:
        if phase == "start":
            if self._following and not _profiler._is_profiler_enabled:
                return
            self._gc_span = _Span(self, "gc")
            self._gc_span.__enter__()
        elif self._gc_span is not None:
            self._gc_span.__exit__()
            self._gc_span = None


TRACE = SpanRecorder()


def chrome_span_events(rec: SpanRecorder, base_ns: int, pid: int
                       ) -> List[Dict]:
    """``rec``'s closed spans as Chrome trace events on a process track of
    their own (``pid``), in microseconds after ``base_ns`` on the Unix-ns
    clock; nesting shows as a stack."""
    out = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "arcle_tpu_torch spans"}},
           {"ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
            "args": {"sort_index": -1}}]
    for name, a, b, _ in rec.spans:
        if b:
            out.append({"ph": "X", "cat": "span", "name": name, "pid": pid,
                        "tid": 0,
                        "ts": (rec.to_unix_ns(a) - base_ns) / 1e3,
                        "dur": (b - a) / 1e3})
    return out


@contextlib.contextmanager
def profile_trace(logdir: str = "./torch-trace") -> Iterator:
    """``torch.profiler`` trace context: host activity, and the device's
    where CUDA is available, with ``TRACE`` recording.  Yields the profiler
    (``key_averages()`` and ``events()`` are readable after the block); on
    exit a Chrome trace ``trace_<pid>_<ns>.json`` lies under ``logdir``
    (open it in Perfetto or ``chrome://tracing``), the program's spans on a
    track above the host's and the device's."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        TRACE.start()
        try:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            TRACE.stop()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    pids = [e["pid"] for e in events if isinstance(e.get("pid"), int)]
    events += chrome_span_events(TRACE, trace.get("baseTimeNanoseconds", 0),
                                 max(pids, default=0) + 1)
    with open(path, "w") as f:
        json.dump(trace, f)
