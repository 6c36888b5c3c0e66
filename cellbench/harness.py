"""What every cell's run shares: the cell's files, the card, the caches,
the measured window, the device trace and the result line."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / ".cache"
BANNED = ("jax", "jaxlib", "flax", "arcle_tpu")


def set_cache_dirs() -> None:
    """Triton's cache at a fixed path inside the checkout, so that only a
    cell's first run there compiles (the step kernel builds into the
    port's own ``arcle_tpu_torch/_build/``)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``: 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def loaded_banned() -> List[str]:
    """Top-level names of loaded modules that the benchmark never loads,
    compared whole (``arcle_tpu_torch`` is not ``arcle_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


# ---- the cell's files ----------------------------------------------------
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    its traffic mix, its limits and the metrics it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"cellbench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    bench_dir = BENCH_DIR
    mine = lambda ms: [m for m in ms if workload in m.get(
        "workloads", [workload])]
    return {"cell": cell, "run_seconds": bench["run_seconds"],
            "config": load_json(ROOT / conf["file"]),
            "traffic": load_json(bench_dir / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(bench_dir / "limits" / f"{workload}.json"),
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def driver(name: str):
    return importlib.import_module(f"cellbench.drivers.{name}")


def kind(name: str):
    return importlib.import_module(f"cellbench.kinds.{name}")


def metric_reader(name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py`` (a name may hold dots), or
    where there is none, of ``metrics/<base>.py``, ``base`` the name
    before its first dot: one reader serves every suffix it reads the
    same way."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "cellbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---- the card --------------------------------------------------------------
def require_cards(n: int) -> None:
    """Exit with an error, printing no result, without ``n`` CUDA cards."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cellbench: the cell needs {n} CUDA card(s), found {have}; "
              "nothing runs on the CPU", file=sys.stderr)
        raise SystemExit(2)


def power_limit_w(index: int = 0) -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ---- spans -----------------------------------------------------------------
class Spans:
    """The benchmark's own spans on the host clock, kept in memory: a
    label and its start and end in ns.  Off, ``span`` costs one test."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[Tuple[str, int, int]] = []

    def add(self, label: str, t0: int, t1: int) -> None:
        if self.on:
            self.items.append((label, t0, t1))

    def total_ns(self, label: str) -> Tuple[int, int]:
        """Summed duration and count of the spans named ``label``."""
        d = [b - a for name, a, b in self.items if name == label]
        return sum(d), len(d)


# ---- the device trace ------------------------------------------------------
class Trace:
    """``torch.profiler`` over the measured window, CUDA activity only.
    A tiny marker kernel opens the window, so its device time anchors the
    host's spans and the CUDA events' times on the trace's clock."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.start_event = None
        self.kernels: List[Tuple[str, int, int]] = []

    def _sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        dev = "cuda" if self.cuda else "cpu"
        self.marker = torch.zeros(1, device=dev)
        self._sync()
        # on the CPU (the tests alone) the host's own operators stand in
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        self.host_marker_ns = time.perf_counter_ns()
        self.marker.add_(1.0)
        if self.cuda:
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()

    def stop(self) -> None:
        self._sync()
        self.prof.__exit__(None, None, None)
        want = "CUDA" if self.cuda else "CPU"
        # the raw kineto events: building profiler FunctionEvents for
        # millions of operations would take minutes
        raw = [(e.name(), int(e.start_ns()), int(e.duration_ns()))
               for e in self.prof.profiler.kineto_results.events()
               if str(e.device_type()).endswith(want)]
        raw.sort(key=lambda x: x[1])
        self.kernels = raw
        self.prof = None

    @property
    def origin_ns(self) -> int:
        """Trace time of the marker kernel's end: the window's device
        origin, and where ``start_event`` was reached."""
        if not self.kernels:
            return 0
        name, t, d = self.kernels[0]
        return t + d

    def busy_idle(self, window_s: float) -> Tuple[float, List[Tuple[int,
                                                                    int]]]:
        """Seconds in which some operation ran on the device within the
        window, and the idle gaps (trace ns)."""
        t0 = self.origin_ns
        t1 = t0 + int(window_s * 1e9)
        busy, gaps, cur = 0, [], t0
        for _, s, d in self.kernels[1:]:
            e = min(s + d, t1)
            s = max(s, t0)
            if e <= cur:
                continue
            if s > cur:
                gaps.append((cur, s))
                cur = s
            busy += e - cur
            cur = e
        if cur < t1:
            gaps.append((cur, t1))
        return busy / 1e9, gaps

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, int] = {}
        for name, _, d in self.kernels[1:]:
            key = name if len(name) <= 160 else name[:157] + "..."
            tot[key] = tot.get(key, 0) + d
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in ranked]

    def kernel_seconds(self, prefix: str) -> float:
        """Device seconds of the kernels whose function name begins
        ``prefix`` (a demangled name's return type and namespaces
        aside)."""
        return sum(d for n, _, d in self.kernels[1:]
                   if function_name(n).startswith(prefix)) / 1e9


def function_name(name: str) -> str:
    """``void (anonymous namespace)::step_kernel<30, 30, 4>(Params)`` ->
    ``step_kernel``."""
    n = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?(?:\w+::)*(\w+)", n)
    return m.group(1) if m else n


def label_gaps(gaps: Sequence[Tuple[int, int]],
               phases: Sequence[Tuple[str, int, int]], top: int = 10
               ) -> List[List]:
    """Idle time by what the host was doing when each gap ended:
    ``phases`` are (label, start, end) on the trace's clock.  Returns
    ``[[label (gaps, longest), seconds], ...]``, the most idle first."""
    import bisect
    starts = [p[1] for p in phases]
    agg: Dict[str, List[int]] = {}
    for a, b in gaps:
        at = b - 1000
        i = bisect.bisect_right(starts, at) - 1
        label = phases[i][0] if i >= 0 and phases[i][2] >= at else "other"
        s = agg.setdefault(label, [0, 0, 0])
        s[0] += b - a
        s[1] += 1
        s[2] = max(s[2], b - a)
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return [[f"{k} ({v[1]} gaps, longest {v[2] / 1e6:.3f} ms)", v[0] / 1e9]
            for k, v in ranked]


# ---- the result --------------------------------------------------------------
def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def print_checks(checks: Sequence[Tuple[str, float, float]]) -> None:
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
