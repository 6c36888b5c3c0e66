"""Golden-trace replay in the port (``arcle_tpu_torch.validation``).

The port's generators give ``arcle_tpu``'s golden set (same seeds, same
traces, every recorded grid equal); the whole set (>= 200 traces, random
walks and the scripted adversarial ones) replays at 100 % through the
native backend, and a subset of about 700 steps through the torch backend
on the CPU; the first-selection harness too.  ``chip_smoke.py`` replays
the whole set through the card.
"""

import numpy as np
import pytest

from arcle_tpu.validation import (
    generate_adversarial_traces as j_adversarial,
    generate_golden_traces as j_golden,
)

from arcle_tpu_torch.envs import O2ARCv2Env
from arcle_tpu_torch.loaders import ListLoader, make_tasks
from arcle_tpu_torch.oracle import OracleEnv
from arcle_tpu_torch.validation import (
    ReplayReport, convert_ui_action, generate_adversarial_traces,
    generate_golden_traces, replay_trace, replay_trace_firstsel,
)


def golden_set(golden, adversarial):
    """>= 200 traces: random walks plus the scripted adversarial traces,
    the adversarial tasks appended after the random walks' tasks."""
    tasks, traces, infos = golden(n_traces=130, seed=3, n_steps=25)
    atasks, atraces, ainfos = adversarial(seed=9)
    n = len(tasks)
    return (list(tasks) + list(atasks), traces + atraces,
            infos + [(ti + n, sub) for ti, sub in ainfos])


@pytest.fixture(scope="module")
def golden():
    out = golden_set(generate_golden_traces, generate_adversarial_traces)
    assert len(out[1]) >= 200
    return out


def replay_all(env, traces, infos, replay=replay_trace):
    report = ReplayReport()
    steps = 0
    for idx, (trace, (ti, sub)) in enumerate(zip(traces, infos)):
        replay(env, trace, {"adaptation": False, "prob_index": ti,
                            "subprob_index": sub}, idx, report)
        steps += env.action_steps
    return report, steps


def test_same_traces_as_arcle_tpu(golden):
    tasks, traces, infos = golden
    j_tasks, j_traces, j_infos = golden_set(j_golden, j_adversarial)
    assert infos == j_infos and len(traces) == len(j_traces)
    for a, b in zip(tasks, j_tasks):
        for la, lb in zip(a[:4], b[:4]):
            for x, y in zip(la, lb):
                np.testing.assert_array_equal(x, y)
        assert a[4] == b[4]
    for t, (a, b) in enumerate(zip(traces, j_traces)):
        assert len(a) == len(b), t
        for ea, eb in zip(a, b):
            assert ea[:3] == eb[:3], t
            assert ea[3].dtype == eb[3].dtype == np.int8
            np.testing.assert_array_equal(ea[3], eb[3], err_msg=f"trace {t}")


def test_convert_convention():
    op, sel = convert_ui_action((0, "RotateCW", [(1, 2), (4, 6)], None))
    assert op == 25 and sel[1:5, 2:7].all() and sel.sum() == 4 * 5
    op, sel = convert_ui_action((0, "RotateCCW", [(0, 0), (1, 1)], None))
    assert op == 24 and sel.sum() == 4
    assert convert_ui_action((0, "FlipX", [(0, 0), (0, 0)], None))[0] == 27
    assert convert_ui_action((0, "FlipY", [(0, 0), (0, 0)], None))[0] == 26
    op, sel = convert_ui_action((0, "FloodFill", [(3, 4), 7], None))
    assert op == 17 and sel[3, 4] and sel.sum() == 1
    op, sel = convert_ui_action((0, "Fill", [(1, 1), (2, 3), 6], None))
    assert op == 6 and sel.sum() == 6
    op, sel = convert_ui_action((0, "ResizeGrid", [(3, 5)], None))
    assert op == 33 and sel[:3, :5].all() and sel.sum() == 15
    assert [convert_ui_action((0, n, [], None))[0] for n in
            ("CopyFromInput", "ResetGrid", "Submit")] == [31, 32, 34]
    with pytest.raises(ValueError):
        convert_ui_action((0, "Teleport", [], None))
    report = ReplayReport()
    env = O2ARCv2Env(data_loader=ListLoader(make_tasks(2, seed=0)),
                     backend="native")
    assert not replay_trace(env, [(0, "Teleport", [], None)], {}, 7, report)
    assert report.omitted == [7] and report.tested == 0


def test_golden_through_native(golden):
    tasks, traces, infos = golden
    env = O2ARCv2Env(data_loader=ListLoader(tasks), max_trial=-1,
                     backend="native")
    report, steps = replay_all(env, traces, infos)
    assert report.tested == len(traces)
    assert report.pass_rate == 100.0, report.summary()
    assert steps == sum(map(len, traces))
    # the first-selection harness: only grid_dim per step
    report, _ = replay_all(env, traces, infos, replay_trace_firstsel)
    assert report.tested == len(traces)
    assert report.pass_rate == 100.0, report.summary()


def test_golden_subset_through_torch_cpu(golden):
    """Every fifth random walk and one adversarial trace of each script,
    about 700 steps."""
    tasks, traces, infos = golden
    pick = list(range(0, 130, 5)) + list(range(130, 135))
    env = O2ARCv2Env(data_loader=ListLoader(tasks), max_trial=-1,
                     device="cpu")
    report, steps = replay_all(env, [traces[i] for i in pick],
                               [infos[i] for i in pick])
    assert report.tested == len(pick)
    assert report.pass_rate == 100.0, report.summary()
    assert steps == sum(len(traces[i]) for i in pick) <= 800, steps


def test_firstsel_variant():
    """First-selection harness (o2arc_check_firstsel): object-op sequences
    recorded with continuation semantics replay with only grid_dim
    compared, through the torch backend on the CPU."""
    rng = np.random.default_rng(5)
    tasks = make_tasks(4, seed=6)
    traces, infos = [], []
    for _ in range(8):
        ti = int(rng.integers(0, len(tasks)))
        orc = OracleEnv("o2arc", max_trial=-1)
        orc.reset(tasks[ti][2][0], tasks[ti][3][0])
        trace = []
        a = (int(rng.integers(0, 8)), int(rng.integers(0, 8)))
        b = (a[0] + int(rng.integers(1, 4)), a[1] + int(rng.integers(1, 4)))
        seq = [("Move", [a, b, "R"], False)]
        for _ in range(4):
            name = ["Move", "RotateCW", "FlipX"][int(rng.integers(0, 3))]
            seq.append((name, [a, b, "D"] if name == "Move" else [a, b],
                        True))
        for name, data, cont in seq:
            op, sel = convert_ui_action((None, name, data, None))
            st, _r, term = orc.step(
                np.zeros((30, 30), np.int8) if cont else sel.astype(np.int8),
                op)
            h, w = (int(v) for v in st["grid_dim"])
            trace.append((0, name, data, st["grid"][:h, :w].copy()))
        traces.append(trace)
        infos.append((ti, 0))
    env = O2ARCv2Env(data_loader=ListLoader(tasks), max_trial=-1,
                     device="cpu")
    report, steps = replay_all(env, traces, infos, replay_trace_firstsel)
    assert report.tested == 8 and steps == 40
    assert report.pass_rate == 100.0, report.summary()
