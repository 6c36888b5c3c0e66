"""The port's own spans, as a traced run reads them, and the idle gaps of
the device trace put down to the span that launched the work ending each.

The port records its spans (``arcle_tpu_torch/utils/metrics.py::TRACE``)
while ``torch.profiler`` traces, so a ``--trace 1`` run finds the window's
spans there: ``[name, start ns, end ns, parent index]`` on the host's
``perf_counter_ns`` clock, with a ``(perf_counter_ns, time_ns)`` pair that
maps them onto the trace's Unix-ns clock.  A port without the recorder
gives none, and every reader of them returns None."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

# host calls that put work on the card, as the device trace's CUDA API
# records name them
LAUNCH_NAMES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def recorder():
    """The port's span recorder, or None where the port has none."""
    try:
        from arcle_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    return TRACE if TRACE.clock is not None else None


def program_spans() -> Optional[List[list]]:
    """The port's recorded spans, or None where it recorded none."""
    rec = recorder()
    return list(rec.spans) if rec is not None and rec.spans else None


def count(spans: Sequence[list], name: str) -> int:
    return sum(1 for s in spans if s[0] == name and s[2])


def total_ns(spans: Sequence[list], name: str) -> int:
    return sum(s[2] - s[1] for s in spans if s[0] == name and s[2])


def mean_us(name: str) -> Optional[float]:
    """Mean host microseconds of the spans named ``name``."""
    spans = program_spans()
    n = count(spans, name) if spans else 0
    return total_ns(spans, name) / n / 1e3 if n else None


def under(spans: Sequence[list], i: int, name: str) -> bool:
    """Whether span ``i`` has an ancestor named ``name``."""
    p = spans[i][3]
    while p >= 0:
        if spans[p][0] == name:
            return True
        p = spans[p][3]
    return False


# ---- the idle gaps ----------------------------------------------------------
def self_segments(spans: Sequence[list], offset_ns: int = 0
                  ) -> List[Tuple[int, int, str]]:
    """The span tree flattened into non-overlapping ``(start, end, path)``
    segments, each instant given to the innermost span open then, its path
    the names from the root down (``iteration/rollout/env.step``), shifted
    by ``offset_ns``.  ``spans`` lie in the order they opened and nest, as
    the recorder keeps them."""
    spans = list(spans)
    paths: List[str] = []
    for name, _, _, parent in spans:
        paths.append(name if parent < 0 else f"{paths[parent]}/{name}")
    segs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []
    cur = 0

    def emit(a: int, b: int, path: str) -> None:
        if b > a:
            segs.append((a + offset_ns, b + offset_ns, path))

    for i, (name, a, b, _) in enumerate(spans):
        if not b:
            continue
        while stack and stack[-1][0] <= a:
            end, path = stack.pop()
            emit(cur, end, path)
            cur = max(cur, end)
        if stack:
            emit(cur, a, stack[-1][1])
        stack.append((b, paths[i]))
        cur = a
    while stack:
        end, path = stack.pop()
        emit(cur, end, path)
        cur = max(cur, end)
    return segs


def span_at(segs: Sequence[Tuple[int, int, str]], starts: Sequence[int],
            t: int) -> Optional[str]:
    """The path of the segment holding instant ``t``, or None."""
    k = bisect.bisect_right(starts, t) - 1
    return segs[k][2] if k >= 0 and t < segs[k][1] else None


def launching_spans(gaps: Sequence[Tuple[int, int]],
                    ops: Sequence[Tuple[int, int]],
                    launches: Dict[int, int],
                    segs: Sequence[Tuple[int, int, str]]
                    ) -> List[Optional[str]]:
    """For each idle gap ``(start, end)``, the path of the program span
    open on the host when the device operation that ends the gap was
    launched, or None where no operation starts at the gap's end, no
    launch record shares its correlation id, or no span was open.
    ``ops``: ``(start, correlation id)`` of the device operations, by
    start; ``launches``: correlation id -> launch instant; all on the
    trace's clock."""
    op_starts = [s for s, _ in ops]
    seg_starts = [s[0] for s in segs]
    out: List[Optional[str]] = []
    for _, b in gaps:
        j = bisect.bisect_left(op_starts, b)
        t = launches.get(ops[j][1]) if j < len(ops) and op_starts[j] == b \
            else None
        out.append(None if t is None else span_at(segs, seg_starts, t))
    return out


def label_idle(gaps: Sequence[Tuple[int, int]],
               labels: Sequence[Optional[str]],
               phases: Sequence[Tuple[str, int, int]], label_gaps,
               top: int = 10) -> List[List]:
    """``label_gaps``' ranking with each gap labelled by its launching span
    where ``labels`` has one, else by ``label_gaps``' own rule: the phase
    open 1 us before the gap's end, then ``other``.  Each gap's label rides
    in a phase of its own that ends at the gap's end, so ``label_gaps``
    (the harness's) ranks and formats them."""
    starts = [p[1] for p in phases]
    per_gap = []
    for (a, b), label in zip(gaps, labels):
        if label is None:
            at = b - 1000
            i = bisect.bisect_right(starts, at) - 1
            label = phases[i][0] if i >= 0 and phases[i][2] >= at \
                else "other"
        per_gap.append((label, b - 1000, b))
    return label_gaps(gaps, per_gap, top)
