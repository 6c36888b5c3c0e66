"""A traced run of one cell with its idle gaps put down to the port's spans.

    python3 cellbench/attribute.py --workload <name> --seed <n> --seconds <s>

Runs ``run.py``'s traced run (``--trace 1``) with two changes: the device
trace keeps the CUDA-runtime records of the calls that launched each
device operation (matched by correlation id), and ``breakdown.idle_gaps``
labels each idle gap by the path of the innermost port span open on the
host when the operation ending the gap was launched
(``iteration/rollout/env.step/auto_reset``).  Spans reach the trace's
clock by the port recorder's ``(perf_counter_ns, time_ns)`` pair.  A gap
with no linked launch, or launched outside every span, keeps ``run.py``'s
rule, marked ``phase:``: the cell's phase open 1 us before its end, else
``other``.

Standard output is ``run.py``'s result line with the new labels.  Standard
error adds the cross-checks: the clock pair's offset against the marker
kernel's, where the marker's own launch falls, the clock pair's drift over
the run, the share of the step kernel's launches inside a ``step_kernel``
span, the idle seconds labelled by a program span, the longest gap and its
label, and the spans per iteration."""

from __future__ import annotations

import bisect
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _here]
    sys.path.insert(0, str(_here.parent))

from cellbench import harness as H  # noqa: E402
from cellbench import run as R  # noqa: E402
from cellbench import spans as S  # noqa: E402

_phase_labels = H.label_gaps


class LinkedTrace(H.Trace):
    """``H.Trace`` that also keeps, for each device operation, the
    correlation id of its launch, the host instants of the CUDA API calls
    (``cuda*``, ``cu*``) by correlation id, and those calls that took 1 ms
    or more."""

    last = None

    def start(self) -> None:
        LinkedTrace.last = self
        super().start()

    def stop(self) -> None:
        self._sync()
        self.prof.__exit__(None, None, None)
        want = "CUDA" if self.cuda else "CPU"
        dev, self.launches, self.n_launches, self.slow = [], {}, 0, []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if str(e.device_type()).endswith(want):
                dev.append((name, int(e.start_ns()), int(e.duration_ns()),
                            int(e.correlation_id())))
            elif self.cuda and name.startswith("cu"):
                t = int(e.start_ns())
                self.launches[int(e.correlation_id())] = t
                self.n_launches += name in S.LAUNCH_NAMES
                if e.duration_ns() >= 1_000_000:
                    self.slow.append((t, int(e.duration_ns()), name))
        dev.sort(key=lambda x: x[1])
        self.kernels = [d[:3] for d in dev]
        self.corr = [d[3] for d in dev]
        self.prof = None


def _say(*a) -> None:
    print("attribute:", *a, file=sys.stderr, flush=True)


def label_gaps(gaps, phases, top: int = 10):
    """``H.label_gaps``' replacement: gaps by launching span."""
    tr, rec = LinkedTrace.last, S.recorder()
    if tr is None or rec is None or not rec.spans:
        _say("no program spans: run.py's labels")
        return _phase_labels(gaps, phases, top)
    offset = rec.clock[1] - rec.clock[0]
    pc = time.perf_counter_ns()
    drift = time.time_ns() - (pc + time.perf_counter_ns()) // 2 - offset
    _say(f"clock pair: Unix minus perf_counter {offset} ns, drifted "
         f"{drift / 1e3:.3f} us by now")
    if tr.kernels:
        marker = tr.kernels[0][1] - tr.host_marker_ns
        _say(f"offset: marker kernel {marker} ns, "
             f"difference {(marker - offset) / 1e3:.3f} us")
        t = tr.launches.get(tr.corr[0])
        if t is not None:
            _say("the marker's launch record lies "
                 f"{(t - tr.host_marker_ns - offset) / 1e3:.3f} us after "
                 "the host's stamp before it")
    segs = S.self_segments(rec.spans, offset)
    ops = [(k[1], c) for k, c in zip(tr.kernels[1:], tr.corr[1:])]
    labels = S.launching_spans(gaps, ops, tr.launches, segs)

    # the step kernel's launches inside the spans that wrap it
    starts = [s[0] for s in segs]
    mine = [tr.launches.get(c) for k, c in zip(tr.kernels, tr.corr)
            if H.function_name(k[0]).startswith("step_kernel")]
    linked = [t for t in mine if t is not None]
    inside = sum(1 for t in linked
                 if (S.span_at(segs, starts, t) or "").endswith(
                     "step_kernel"))
    _say(f"step kernel: {len(mine)} operations, {len(linked)} linked to a "
         f"launch, {inside} launched inside a step_kernel span")
    _say(f"launch records: {tr.n_launches} of "
         f"{', '.join(S.LAUNCH_NAMES)}; {len(tr.kernels) - 1} device "
         "operations after the marker")

    idle = sum(b - a for a, b in gaps) or 1
    by_span = sum(b - a for (a, b), l in zip(gaps, labels) if l)
    _say(f"idle: {idle / 1e9:.6f} s, {100 * by_span / idle:.2f}% labelled "
         "by a program span")
    if gaps:
        j = max(range(len(gaps)), key=lambda i: gaps[i][1] - gaps[i][0])
        a, b = gaps[j]
        host = {}
        for s0, s1, path in segs[max(bisect.bisect_right(starts, a) - 1, 0):
                                 bisect.bisect_left(starts, b)]:
            host[path] = host.get(path, 0) + min(s1, b) - max(s0, a)
        busy = sorted(((v, k) for k, v in host.items() if v > 0),
                      reverse=True)[:3]
        calls = [f"{n} {d / 1e6:.3f} ms" for t, d, n in tr.slow
                 if t < b and t + d > a]
        _say(f"longest gap: {(b - a) / 1e6:.3f} ms, launching span "
             f"{labels[j]}; the host meanwhile in " + ", ".join(
                 f"{k} {v / 1e6:.3f} ms" for v, k in busy)
             + "; CUDA calls of 1 ms or more in it: "
             + (", ".join(calls) or "none"))
    n_gc = S.count(rec.spans, "gc")
    _say(f"gc: {n_gc} passes, {S.total_ns(rec.spans, 'gc') / 1e6:.3f} ms")
    n_it = S.count(rec.spans, "iteration")
    if n_it:
        T = S.count(rec.spans, "env.step") / n_it
        ms = {k: S.total_ns(rec.spans, k) / n_it / 1e6 for k in (
            "iteration", "rollout", "learner_batch", "update")}
        _say("spans, ms an iteration: " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items()) + f"; rollout and "
            f"learner_batch {(ms['rollout'] + ms['learner_batch']) / T:.4f}"
            " ms a step")
    marked = [(f"phase:{p[0]}",) + tuple(p[1:]) for p in phases]
    return S.label_idle(gaps, labels, marked, _phase_labels, top)


def main(argv=None, device: str = "cuda") -> int:
    """``run.py``'s traced run with the launching spans' labels."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    H.Trace, H.label_gaps = LinkedTrace, label_gaps
    return R.main(argv, device=device)


if __name__ == "__main__":
    raise SystemExit(main())
