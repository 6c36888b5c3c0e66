"""The port's spans in a traced run: their readers on the CPU at tiny
sizes, and idle gaps put down to the span that launched the work ending
each, on synthetic traces."""

from __future__ import annotations

import json

import pytest

from cellbench import harness as H
from cellbench import spans as S
from cellbench.tests.tiny import run_cell, run_in, tiny_copy

NEW = ("policy_host_us_per_step", "env_step_host_us_per_step",
       "step_kernel_host_us_per_launch", "auto_reset_host_us_per_step",
       "learner_batch_ms_per_iter")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", ["o2arc_mlp.ppo",
                                      "o2arc_mlp.random_act"])
def test_a_traced_run_reports_the_ports_spans(tiny, workload):
    out = run_cell(tiny, workload, seed=4_000_000_007, trace=1)
    assert out["correct"] is True
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"]
            if workload in m["workloads"] and m["name"].split(".")[0] in NEW}
    assert want and want <= set(out["metrics"])
    for name in want:
        assert out["metrics"][name]["value"] > 0, name
    # no device operations on the CPU
    assert not any(m.startswith("launches_per_step") for m in out["metrics"])


def test_the_attributed_run_prints_run_pys_line(tiny):
    proc = run_in(tiny, (
        "from cellbench.attribute import main\n"
        "raise SystemExit(main(['--workload', 'o2arc_mlp.random_act', "
        "'--seed', '8', '--seconds', '0.5'], device='cpu'))\n"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["breakdown"]["idle_gaps"]
    assert "attribute: idle:" in proc.stderr


# a rollout step on the host clock: env.step holds step_kernel, then the
# rollout's own code, then a policy forward
SPANS = [["iteration", 0, 1000, -1], ["rollout", 10, 900, 0],
         ["env.step", 100, 300, 1], ["step_kernel", 120, 200, 2],
         ["gc", 140, 160, 3], ["policy", 400, 500, 1]]


def test_self_segments_cover_each_span_once():
    segs = S.self_segments(SPANS, offset_ns=5)
    assert all(a < b for a, b, _ in segs)
    assert all(b <= c for (_, b, _), (c, _, _) in zip(segs, segs[1:]))
    got = {}
    for a, b, path in segs:
        got[path] = got.get(path, 0) + b - a
    assert got == {"iteration": 110, "iteration/rollout": 590,
                   "iteration/rollout/env.step": 120,
                   "iteration/rollout/env.step/step_kernel": 60,
                   "iteration/rollout/env.step/step_kernel/gc": 20,
                   "iteration/rollout/policy": 100}
    # a span's self time and its children's sum to its duration
    step = sum(v for k, v in got.items() if "/env.step" in k)
    assert step == 300 - 100
    assert segs[0][0] == 5 and segs[-1][1] == 1005


def test_idle_gaps_go_to_the_launching_span():
    off = 10_000
    segs = S.self_segments(SPANS, off)
    # gaps (trace clock) ended by operations whose launches (host instants
    # + offset) fell: in step_kernel; in env.step after step_kernel closed;
    # in the rollout's own code; unlinked; outside every span
    gaps = [(0, 2000), (3000, 4000), (5000, 6000), (7000, 8000),
            (9000, 9500)]
    ops = [(2000, 11), (4000, 12), (6000, 13), (8000, 14), (9500, 15)]
    launches = {11: off + 150 - 30, 12: off + 250, 13: off + 600,
                15: off + 5000}
    labels = S.launching_spans(gaps, ops, launches, segs)
    assert labels == ["iteration/rollout/env.step/step_kernel",
                      "iteration/rollout/env.step", "iteration/rollout",
                      None, None]
    phases = [("rollout", 6900, 8100)]
    out = S.label_idle(gaps, labels, phases, H.label_gaps)
    got = {row[0].split(" (")[0]: row[1] for row in out}
    assert got == {"iteration/rollout/env.step/step_kernel": 2e-6,
                   "iteration/rollout/env.step": 1e-6,
                   "iteration/rollout": 1e-6, "rollout": 1e-6,
                   "other": 0.5e-6}
    assert out[0][0] == ("iteration/rollout/env.step/step_kernel "
                         "(1 gaps, longest 0.002 ms)")


@pytest.mark.parametrize("port", ["no spans", "no recorder"])
def test_a_port_without_spans_reads_none(port):
    """The readers return nothing where the port recorded no span, or has
    no recorder at all."""
    setup = ("TRACE.start(); TRACE.stop()\n" if port == "no spans" else
             "import sys, types\n"
             "sys.modules['arcle_tpu_torch.utils.metrics'] = "
             "types.ModuleType('stub')\n")
    code = (
        "from arcle_tpu_torch.utils.metrics import TRACE\n" + setup +
        "from cellbench import harness as H\n"
        "for n in ('policy_host_us_per_step.train', "
        "'env_step_host_us_per_step.engine', "
        "'step_kernel_host_us_per_launch.train', "
        "'auto_reset_host_us_per_step.engine', "
        "'learner_batch_ms_per_iter.train', 'launches_per_step.eval'):\n"
        "    assert H.metric_reader(n)({}) is None, n\n")
    proc = run_in(H.ROOT, code)
    assert proc.returncode == 0, proc.stderr[-2000:]
