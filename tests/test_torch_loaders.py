"""``arcle_tpu_torch.loaders`` against ``arcle_tpu.loaders``: the same seeds
and files must give bit-identical task banks."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from arcle_tpu import loaders as jl
from arcle_tpu.loaders import synthetic as jsyn

from arcle_tpu_torch import loaders as tl
from arcle_tpu_torch.loaders import synthetic as tsyn


def assert_banks_equal(jbank, tbank):
    for f in dataclasses.fields(tbank):
        a = np.asarray(getattr(jbank, f.name))
        b = getattr(tbank, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("n_tasks,seed", [(16, 3), (8, 0)])
def test_synthetic_bank_bit_identical(n_tasks, seed):
    assert_banks_equal(jl.SyntheticLoader(n_tasks, seed=seed).bank(),
                       tl.SyntheticLoader(n_tasks, seed=seed).bank(device="cpu"))


def test_list_loader_bank_and_geometry():
    tasks_j = jsyn.make_tasks(6, seed=2, min_size=1, max_size=30)
    tasks_t = tsyn.make_tasks(6, seed=2, min_size=1, max_size=30)
    for a, b in zip(tasks_j, tasks_t):
        assert a[-1] == b[-1]
        for xs, ys in zip(a[:4], b[:4]):
            for x, y in zip(xs, ys):
                np.testing.assert_array_equal(x, y)
    assert_banks_equal(jl.ListLoader(tasks_j).bank(),
                       tl.ListLoader(tasks_t).bank(device="cpu"))
    # the 5x5 geometry of the answer-given suite
    small_j = jsyn.make_tasks(4, seed=1, min_size=5, max_size=5)
    small_t = tsyn.make_tasks(4, seed=1, min_size=5, max_size=5)
    assert_banks_equal(jl.ListLoader(small_j).bank(5, 5),
                       tl.ListLoader(small_t).bank(5, 5, device="cpu"))


def test_pair_index_and_count():
    tasks = tsyn.make_tasks(7, seed=4, n_train=2, n_test=2)
    jbank = jl.ListLoader(tasks).bank()
    tbank = tl.ListLoader(tasks).bank(device="cpu")
    probs = np.repeat(np.arange(7, dtype=np.int32), 4)
    subs = np.tile(np.array([0, 1, 0, 1], np.int32), 7)
    adapt = np.tile(np.array([True, True, False, False]), 7)
    ji = np.asarray([jbank.pair_index(p, s, a)
                     for p, s, a in zip(probs, subs, adapt)])
    jc = np.asarray([jbank.pair_count(p, a) for p, a in zip(probs, adapt)])
    ti = tbank.pair_index(torch.from_numpy(probs), torch.from_numpy(subs),
                          torch.from_numpy(adapt))
    tc = tbank.pair_count(torch.from_numpy(probs), torch.from_numpy(adapt))
    np.testing.assert_array_equal(ji, ti.numpy())
    np.testing.assert_array_equal(jc, tc.numpy())
    assert sorted(ti.tolist()) == list(range(tbank.n_pairs))


@pytest.mark.parametrize("train", [True, False])
def test_arc_loader_bundled_matches(train):
    jd, td = jl.ARCLoader(train=train), tl.ARCLoader(train=train)
    assert [d[-1]["id"] for d in jd.data] == [d[-1]["id"] for d in td.data]
    assert_banks_equal(jd.bank(), td.bank(device="cpu"))


def test_miniarc_loader_null_cells(tmp_path):
    """Literal ``null`` cells read as 0, ids and descriptions from the
    file name, as the JAX package parses them."""
    text = ('{"train": [{"input": [[1, null], [0, 2]], '
            '"output": [[null, 3], [4, 0]]}], '
            '"test": [{"input": [[5]], "output": [[null]]}]}')
    (tmp_path / "fill holes_abc123.json").write_text(text)
    (tmp_path / "zz_first.json").write_text(text)
    jd = jl.MiniARCLoader(root=str(tmp_path))
    td = tl.MiniARCLoader(root=str(tmp_path))
    assert [d[-1] for d in jd.data] == [d[-1] for d in td.data]
    assert_banks_equal(jd.bank(), td.bank(device="cpu"))
    assert_banks_equal(jl.MiniARCLoader().bank(5, 5),
                       tl.MiniARCLoader().bank(5, 5, device="cpu"))


def test_write_corpus_identical(tmp_path):
    nj = jsyn.write_corpus(str(tmp_path / "j"), n_tasks=4, seed=5)
    nt = tsyn.write_corpus(str(tmp_path / "t"), n_tasks=4, seed=5)
    assert nj == nt
    names = sorted(os.listdir(tmp_path / "j" / "training"))
    assert names == sorted(os.listdir(tmp_path / "t" / "training"))
    for n in names:
        assert (tmp_path / "j" / "training" / n).read_bytes() == \
            (tmp_path / "t" / "training" / n).read_bytes()
