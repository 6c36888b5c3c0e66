"""Golden-trace replay harness.

The port's copy of ``arcle_tpu/validation/trace_replay.py`` (numpy only,
over the port's oracle and synthetic tasks).  It is the reference's
inherited validation asset (its ``tests/o2arc_check.py``): replay recorded
O2ARC-interface action logs through an environment and check the working
grid against the recorded grid after every action.  The original human
traces are not available, so this module provides

* :func:`convert_ui_action` -- the exact UI-log -> (op, selection) mapping
  of the reference harness (o2arc_check.py:21-99), including the
  RotateCW->25 / RotateCCW->24 / FlipX->27 / FlipY->26 and Fill=rect-Color
  conventions;
* :func:`replay_trace` -- the per-step comparison loop with the
  selection-continuation rule (ops 20..27 with an unchanged selection are
  sent with an *empty* selection, o2arc_check.py:169-170) and the
  tested/failure/error/omitted accounting;
* :func:`generate_golden_traces` and :func:`generate_adversarial_traces`
  -- golden traces produced by the NumPy oracle in the same trace-entry
  format, so the harness runs hermetically.

The replay functions take any object with Gymnasium's ``reset(options=)``
/ ``step(action)`` form, so they run with or without ``gymnasium``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# trace entry format (o2arc_check.py): (timestamp, action_name, data, grid)
TraceEntry = Tuple[object, str, list, np.ndarray]


def convert_ui_action(entry: TraceEntry) -> Tuple[int, np.ndarray]:
    """O2ARC UI log entry -> (operation index, selection mask).

    Raises on unknown action names; callers treat that as "omitted"
    exactly like the reference harness.
    """
    _, action, data, _grid = entry
    sel = np.zeros((30, 30), dtype=np.bool_)
    if action == "CopyFromInput":
        return 31, sel
    if action == "ResizeGrid":
        h, w = data[0]
        sel[:h, :w] = 1
        return 33, sel
    if action == "ResetGrid":
        return 32, sel
    if action == "Submit":
        return 34, sel
    if action == "Color":
        (h, w), op = data[0], data[1]
        sel[h, w] = 1
        return op, sel
    if action == "Fill":
        (h0, w0), (h1, w1), op = data[0], data[1], data[2]
        sel[h0:h1 + 1, w0:w1 + 1] = 1
        return op, sel
    rect_ops = {"FlipX": 27, "FlipY": 26, "RotateCW": 25, "RotateCCW": 24}
    if action in rect_ops:
        (h0, w0), (h1, w1) = data[0], data[1]
        sel[h0:h1 + 1, w0:w1 + 1] = 1
        return rect_ops[action], sel
    if action == "Move":
        (h0, w0), (h1, w1), d = data[0], data[1], data[2]
        sel[h0:h1 + 1, w0:w1 + 1] = 1
        return {"U": 20, "D": 21, "R": 22, "L": 23}[d], sel
    if action == "Copy":
        (h0, w0), (h1, w1), src = data[0], data[1], data[2]
        sel[h0:h1 + 1, w0:w1 + 1] = 1
        return {"Input Grid": 28, "Output Grid": 29}[src], sel
    if action == "Paste":
        h, w = data[0]
        sel[h, w] = 1
        return 30, sel
    if action == "FloodFill":
        (h, w), c = data[0], data[1]
        sel[h, w] = 1
        return 10 + c, sel
    raise ValueError(f"unconvertible action {action!r}")


@dataclasses.dataclass
class ReplayReport:
    tested: int = 0
    failures: List[int] = dataclasses.field(default_factory=list)
    errors: List[int] = dataclasses.field(default_factory=list)
    omitted: List[int] = dataclasses.field(default_factory=list)

    @property
    def pass_rate(self) -> float:
        if self.tested == 0:
            return 0.0
        return (self.tested - len(self.failures) - len(self.errors)) \
            / self.tested * 100.0

    def summary(self) -> str:
        return (f"Tested: {self.tested}, Passed: {self.pass_rate:.2f}% "
                f"(errors {len(self.errors)}, failures {len(self.failures)},"
                f" omitted {len(self.omitted)})")


def replay_trace(env, trace: Sequence[TraceEntry], reset_options: Dict,
                 idx: int, report: ReplayReport) -> bool:
    """Replay one converted trace through a Gymnasium env; compares
    (grid_dim, grid[:h,:w]) to the recorded grid per step
    (o2arc_check.py:184-195)."""
    try:
        converted = [convert_ui_action(e) for e in trace]
    except Exception:
        report.omitted.append(idx)
        return False

    obs, _info = env.reset(options=reset_options)
    report.tested += 1
    for i, (op, sel) in enumerate(converted):
        # selection-continuation rule (o2arc_check.py:169-170)
        if 20 <= op <= 27 and np.array_equal(
                np.asarray(obs["selected"], bool), sel):
            sel = np.zeros((30, 30), dtype=np.bool_)
        try:
            obs, reward, term, trunc, _info = env.step(
                {"selection": sel.astype(np.int8), "operation": op})
        except Exception:
            report.errors.append(idx)
            return False
        h, w = (int(v) for v in obs["grid_dim"])
        want = np.asarray(trace[i][3], np.int8)
        if want.shape != (h, w) or (obs["grid"][:h, :w] != want).any():
            report.failures.append(idx)
            return False
        if term or trunc:
            break
    return True


def replay_trace_firstsel(env, trace: Sequence[TraceEntry],
                          reset_options: Dict, idx: int,
                          report: ReplayReport) -> bool:
    """First-selection variant (o2arc_check_firstsel.py): every object op
    after the first keeps an empty selection (pure continuation), and only
    ``grid_dim`` is compared per step (its :176-181)."""
    try:
        converted = [convert_ui_action(e) for e in trace]
    except Exception:
        report.omitted.append(idx)
        return False

    obs, _info = env.reset(options=reset_options)
    report.tested += 1
    prev_obj_op = False
    for i, (op, sel) in enumerate(converted):
        if 20 <= op <= 27:
            if prev_obj_op:
                sel = np.zeros((30, 30), dtype=np.bool_)
            prev_obj_op = True
        else:
            prev_obj_op = False
        try:
            obs, reward, term, trunc, _info = env.step(
                {"selection": sel.astype(np.int8), "operation": op})
        except Exception:
            report.errors.append(idx)
            return False
        want = np.asarray(trace[i][3], np.int8)
        if tuple(int(v) for v in obs["grid_dim"]) != want.shape:
            report.failures.append(idx)
            return False
        if term or trunc:
            break
    return True


def generate_golden_traces(n_traces: int = 50, seed: int = 0,
                           n_steps: int = 30,
                           tasks: Optional[list] = None):
    """Produce golden traces in the o2arc_check entry format by driving the
    validated NumPy oracle with random UI-style actions.

    Returns (tasks, traces, infos): infos are (task_index, subprob_index)
    pairs the replay pins (the trace-info convention of the reference
    pickles)."""
    from ..oracle import OracleEnv
    from ..loaders.synthetic import make_tasks

    rng = np.random.default_rng(seed)
    if tasks is None:
        tasks = make_tasks(max(8, n_traces // 4), seed=seed + 1)

    def random_ui_action():
        r = int(rng.integers(0, 12))
        p = lambda: (int(rng.integers(0, 30)), int(rng.integers(0, 30)))

        def rect():
            (x1, y1), (x2, y2) = p(), p()
            # normalize per axis (UI semantics; tuple-sort would leave
            # inverted columns producing empty selections)
            return ((min(x1, x2), min(y1, y2)), (max(x1, x2), max(y1, y2)))
        if r == 0:
            return ("Color", [p(), int(rng.integers(0, 10))])
        if r == 1:
            a, b = rect()
            return ("Fill", [a, b, int(rng.integers(0, 10))])
        if r == 2:
            return ("FloodFill", [p(), int(rng.integers(0, 10))])
        if r == 3:
            a, b = rect()
            return ("Move", [a, b, "UDRL"[int(rng.integers(0, 4))]])
        if r == 4:
            a, b = rect()
            return (["RotateCW", "RotateCCW"][int(rng.integers(0, 2))],
                    [a, b])
        if r == 5:
            a, b = rect()
            return (["FlipX", "FlipY"][int(rng.integers(0, 2))], [a, b])
        if r == 6:
            a, b = rect()
            return ("Copy", [a, b, ["Input Grid", "Output Grid"]
                             [int(rng.integers(0, 2))]])
        if r == 7:
            return ("Paste", [p()])
        if r == 8:
            return ("CopyFromInput", [])
        if r == 9:
            return ("ResizeGrid", [(int(rng.integers(1, 31)),
                                    int(rng.integers(1, 31)))])
        if r == 10:
            return ("ResetGrid", [])
        return ("Color", [p(), int(rng.integers(0, 10))])

    traces, infos = [], []
    for t in range(n_traces):
        ti = int(rng.integers(0, len(tasks)))
        test_in, test_out = tasks[ti][2][0], tasks[ti][3][0]
        orc = OracleEnv("o2arc", max_trial=-1)
        orc.reset(test_in, test_out)
        trace = []
        for _s in range(n_steps):
            name, data = random_ui_action()
            op, sel = convert_ui_action((None, name, data, None))
            # the continuation rule applies at record time too: replays
            # send empty selections when the selection is unchanged, and
            # both sides must take the same branch
            st = orc.state
            if 20 <= op <= 27 and np.array_equal(
                    st["selected"].astype(bool), sel):
                sel = np.zeros((30, 30), dtype=np.bool_)
            st, _r, term = orc.step(sel.astype(np.int8), op)
            h, w = (int(v) for v in st["grid_dim"])
            trace.append((_s, name, data, st["grid"][:h, :w].copy()))
            if term:
                break
        traces.append(trace)
        infos.append((ti, 0))
    return tasks, traces, infos


def _selected_rect(st) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """If the oracle's current ``selected`` mask is a solid non-empty
    rectangle, return its ((h0,w0),(h1,w1)) corners, else None.  A UI
    object op whose rectangle equals the live selection converts to an
    empty selection at replay time (the continuation rule), so emitting
    exactly this rectangle scripts *object continuation* in the trace."""
    sel = np.asarray(st["selected"], bool)
    if not sel.any():
        return None
    rows = np.nonzero(sel.any(1))[0]
    cols = np.nonzero(sel.any(0))[0]
    h0, h1 = int(rows[0]), int(rows[-1])
    w0, w1 = int(cols[0]), int(cols[-1])
    if sel[h0:h1 + 1, w0:w1 + 1].all() and \
            sel.sum() == (h1 - h0 + 1) * (w1 - w0 + 1):
        return (h0, w0), (h1, w1)
    return None


def generate_adversarial_traces(seed: int = 0, tasks: Optional[list] = None):
    """Scripted adversarial golden traces exercising the trickiest
    semantics at *trace* level: long object-
    continuation chains, off-grid excursions and returns, serpentine
    flood fills, paste-over-edge, and 4x-rotation parity round trips.

    Same return convention as :func:`generate_golden_traces`; every action
    list is expressed in UI-log form so the traces replay through both
    this engine's gym env and the executed reference env.
    """
    from ..oracle import OracleEnv
    from ..loaders.synthetic import make_tasks

    rng = np.random.default_rng(seed)
    if tasks is None:
        tasks = make_tasks(8, seed=seed + 17)

    def record(script_fn):
        ti = int(rng.integers(0, len(tasks)))
        orc = OracleEnv("o2arc", max_trial=-1)
        orc.reset(tasks[ti][2][0], tasks[ti][3][0])
        trace = []

        def do(name, data):
            op, sel = convert_ui_action((None, name, data, None))
            st = orc.state
            if 20 <= op <= 27 and np.array_equal(
                    st["selected"].astype(bool), sel):
                sel = np.zeros((30, 30), dtype=np.bool_)
            st, _r, _term = orc.step(sel.astype(np.int8), op)
            h, w = (int(v) for v in st["grid_dim"])
            trace.append((len(trace), name, data,
                          st["grid"][:h, :w].copy()))

        script_fn(orc, do)
        return trace, (ti, 0)

    def continuation_chain(orc, do):
        """Lift an object, then a long Move/Rotate/Flip chain where every
        rectangle equals the live selection -> pure continuation."""
        do("ResizeGrid", [(30, 30)])
        a = (int(rng.integers(2, 10)), int(rng.integers(2, 10)))
        b = (a[0] + int(rng.integers(1, 5)), a[1] + int(rng.integers(1, 5)))
        do("Fill", [a, b, int(rng.integers(1, 10))])
        do("Move", [a, b, "R"])            # new object selection
        for _k in range(22):
            r = _selected_rect(orc.state)
            if r is None:
                break
            kind = int(rng.integers(0, 4))
            if kind == 0:
                do("Move", [r[0], r[1], "UDRL"[int(rng.integers(0, 4))]])
            elif kind == 1:
                do("RotateCW", [r[0], r[1]])
            elif kind == 2:
                do("RotateCCW", [r[0], r[1]])
            else:
                do(["FlipX", "FlipY"][int(rng.integers(0, 2))],
                   [r[0], r[1]])

    def offgrid_excursion(orc, do):
        """Walk an object over the grid edge (clipped selection stays a
        rectangle, so the chain continues) and bring it back."""
        do("ResizeGrid", [(30, 30)])
        a, b = (1, 24), (4, 28)
        do("Fill", [a, b, 3])
        do("Move", [a, b, "R"])
        for _ in range(6):                  # push over the right edge
            r = _selected_rect(orc.state)
            if r is None:
                break
            do("Move", [r[0], r[1], "R"])
        for _ in range(8):                  # come back
            r = _selected_rect(orc.state)
            if r is None:
                break
            do("Move", [r[0], r[1], "L"])
        r = _selected_rect(orc.state)
        if r is not None:
            do("RotateCW", [r[0], r[1]])

    def serpentine_flood(orc, do):
        """Serpentine corridor, then flood fill from one end — the
        longest-path propagation case for the fixpoint kernel."""
        do("ResizeGrid", [(30, 30)])
        do("ResetGrid", [])
        for i, r in enumerate(range(1, 29, 2)):   # walls with gaps
            if i % 2 == 0:
                do("Fill", [(r, 0), (r, 28), 2])
            else:
                do("Fill", [(r, 1), (r, 29), 2])
        do("FloodFill", [(0, 0), int(rng.integers(3, 10))])

    def paste_over_edge(orc, do):
        """Clipboard paste whose clip overhangs the 30x30 frame."""
        do("ResizeGrid", [(30, 30)])
        a, b = (0, 0), (4, 4)
        do("Fill", [a, b, 6])
        do("Copy", [a, b, "Output Grid"])
        do("Paste", [(27, 27)])             # clipped bottom-right
        do("Paste", [(0, 26)])              # clipped right
        do("Paste", [(28, 0)])              # clipped bottom
        do("FloodFill", [(15, 15), 4])

    def rotation_parity(orc, do):
        """4x CW rotation of an odd x even rect — the ill-posed parity
        center arithmetic (object.py:197-207) must round-trip."""
        do("ResizeGrid", [(30, 30)])
        a = (int(rng.integers(3, 12)), int(rng.integers(3, 12)))
        b = (a[0] + 2, a[1] + 3)            # 3x4: parity-tracking case
        do("Fill", [a, b, int(rng.integers(1, 10))])
        do("Move", [a, b, "D"])
        for _ in range(4):
            r = _selected_rect(orc.state)
            if r is None:
                break
            do("RotateCW", [r[0], r[1]])
        r = _selected_rect(orc.state)
        if r is not None:
            do("Move", [r[0], r[1], "U"])

    scripts = [continuation_chain, offgrid_excursion, serpentine_flood,
               paste_over_edge, rotation_parity]
    traces, infos = [], []
    for rep in range(16):
        for script in scripts:
            tr, info = record(script)
            traces.append(tr)
            infos.append(info)
    return tasks, traces, infos
