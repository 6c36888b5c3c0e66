"""The port's NumPy oracle (``arcle_tpu_torch.oracle``) against
``arcle_tpu``'s, and the port's plain transition against the port's
oracle directly.

Both fuzzes cover the six op families (raw, arc, o2arc, o2arc at
max_trial 3, o2arc_crop33 at 127, o2arc_nofill), reset-on-submit, every
state field, the reward, ``terminated`` and the step and submit counters,
bit for bit.  Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest
import torch

from arcle_tpu.oracle import OracleEnv as JOracleEnv

from arcle_tpu_torch.core import Action, init_state
from arcle_tpu_torch.ops import arc_table, complete_step, o2arc_table, \
    raw_table
from arcle_tpu_torch.oracle import OracleEnv

FAMILIES = [
    ("raw", lambda: raw_table(-1), -1),
    ("arc", lambda: arc_table(-1), -1),
    ("o2arc", lambda: o2arc_table(-1), -1),
    ("o2arc", lambda: o2arc_table(3), 3),
    ("o2arc_crop33", lambda: o2arc_table(127, crop_at_33=True), 127),
    ("o2arc_nofill", lambda: o2arc_table(-1, no_fill=True), -1),
]
IDS = [f"{f[0]}-mt{f[2]}" for f in FAMILIES]
GRIDS = ("input", "grid", "selected", "clip")
OBJECT = ("object", "object_sel", "background")


def random_selection(rng, H=30, W=30):
    """Empty, one pixel, a box, or sparse cells."""
    style = rng.integers(0, 4)
    sel = np.zeros((H, W), np.int8)
    if style == 1:
        sel[rng.integers(0, H), rng.integers(0, W)] = 1
    elif style == 2:
        x1, x2 = sorted(rng.integers(0, H, 2).tolist())
        y1, y2 = sorted(rng.integers(0, W, 2).tolist())
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    elif style == 3:
        sel[rng.random((H, W)) < 0.08] = 1
    return sel


def random_pair(rng):
    shape = lambda: (int(rng.integers(2, 13)), int(rng.integers(2, 13)))
    return (rng.integers(0, 10, shape()).astype(np.int8),
            rng.integers(0, 10, shape()).astype(np.int8))


def assert_oracle_states_equal(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if k == "object_states":
            for kk, vv in v.items():
                np.testing.assert_array_equal(
                    got[k][kk], vv, err_msg=f"{what} object_states.{kk}")
                assert got[k][kk].dtype == vv.dtype
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")
            assert got[k].dtype == v.dtype, (what, k)
        else:
            assert got[k] == v, (what, k, got[k], v)


@pytest.mark.parametrize("fam,make_table,max_trial", FAMILIES, ids=IDS)
def test_oracle_matches_arcle_tpu(fam, make_table, max_trial):
    n_ops = make_table().n_ops
    rng = np.random.default_rng(7 + IDS.index(f"{fam}-mt{max_trial}"))
    for trial in range(3):
        inp, out = random_pair(rng)
        ros = trial == 2
        ours, ref = OracleEnv(fam, max_trial=max_trial), \
            JOracleEnv(fam, max_trial=max_trial)
        assert ours.n_ops == ref.n_ops == n_ops
        ours.reset(inp, out, reset_on_submit=ros)
        ref.reset(inp, out, reset_on_submit=ros)
        for t in range(120):
            sel = random_selection(rng)
            op = int(rng.integers(0, n_ops))
            if rng.random() < 0.1:
                op = n_ops - 1                    # more Submits
            st_o, r_o, term_o = ours.step(sel, op)
            st_r, r_r, term_r = ref.step(sel, op)
            assert (r_o, term_o) == (r_r, term_r), (fam, t, op)
            assert_oracle_states_equal(st_o, st_r,
                                       f"{fam} trial {trial} step {t}")


def _oracle_field(st, name):
    od = st["object_states"]
    if name in od:
        return od[name]
    return {"steps": st["_steps"],
            "submit_count": st["_submit_count"]}.get(name, st.get(name))


@pytest.mark.parametrize("fam,make_table,max_trial", FAMILIES, ids=IDS)
def test_plain_transition_matches_oracle(fam, make_table, max_trial):
    """A batch of 8 envs through the port's plain step (``complete_step``
    on the CPU), each env against its own oracle: every field of the
    state, the reward and ``terminated`` after every step."""
    table = make_table()
    B, steps = 8, 40
    rng = np.random.default_rng(50 + IDS.index(f"{fam}-mt{max_trial}"))
    pairs = [random_pair(rng) for _ in range(B)]
    ros = np.arange(B) % 2 == 1
    oracles = []
    for (inp, out), r in zip(pairs, ros):
        o = OracleEnv(fam, max_trial=max_trial)
        o.reset(inp, out, reset_on_submit=bool(r))
        oracles.append(o)

    def padded(g):
        out = np.zeros((30, 30), np.int8)
        out[:g.shape[0], :g.shape[1]] = g
        return out

    t = lambda a: torch.from_numpy(np.stack(a))
    st = init_state(t([padded(i) for i, _ in pairs]),
                    t([np.array(i.shape, np.int8) for i, _ in pairs]),
                    t([padded(o) for _, o in pairs]),
                    t([np.array(o.shape, np.int8) for _, o in pairs]),
                    max_trial=max_trial,
                    reset_on_submit=torch.from_numpy(ros.astype(np.int8)))
    for step in range(steps):
        sels = np.stack([random_selection(rng) for _ in range(B)])
        ops = rng.integers(0, table.n_ops, B).astype(np.int32)
        ops[rng.random(B) < 0.1] = table.n_ops - 1
        st, reward, term = complete_step(
            st, Action(selection=torch.from_numpy(sels),
                       operation=torch.from_numpy(ops)), table)
        for b, o in enumerate(oracles):
            ost, orew, oterm = o.step(sels[b], int(ops[b]))
            what = f"{fam} env {b} step {step} op {ops[b]}"
            assert float(reward[b]) == orew and bool(term[b]) == oterm, what
            for name in GRIDS + OBJECT + (
                    "input_dim", "grid_dim", "clip_dim", "object_dim",
                    "object_pos", "trials_remain", "terminated", "active",
                    "rotation_parity", "steps", "submit_count"):
                want = np.asarray(_oracle_field(ost, name)).reshape(-1)
                got = getattr(st, name)[b].numpy().reshape(-1)
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{what} {name}")
