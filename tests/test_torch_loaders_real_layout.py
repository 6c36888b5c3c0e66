"""The port's loaders against a tree in the real corpora's layouts.

Counterpart of ``tests/test_loaders_real_layout.py``: the true ARC
(400/400 tasks under ``ARC/data/{training|evaluation}``, 8-hex-char file
names) and Mini-ARC (``Mini-ARC/data/MiniARC``, human file names, literal
``null`` cells) corpora are not in the repository, so
``arcle_tpu_torch.loaders.write_real_layout_fixture`` writes a tree in
their layouts, once per module, and the port's loaders and ``bake_bank``
run on it at full scale (reference loader.py:72-87,116-157).  The port's
fixture writers are held byte for byte to the JAX package's, and its
full-corpus bank field for field to ``arcle_tpu``'s.
"""

import json
import os
import shutil

import numpy as np
import pytest

from arcle_tpu_torch.loaders import (
    ARCLoader, MiniARCLoader, write_real_layout_fixture, write_sample_dataset,
)


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return write_real_layout_fixture(str(tmp_path_factory.mktemp("real")))


def _files(root):
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as fp:
                out[os.path.relpath(p, root)] = fp.read()
    return out


def test_fixture_writers_match_jax_bytes(tmp_path):
    """Both writers put the same files, byte for byte, where the JAX
    package's do, and return the same description of the tree.  Both
    write under one root: the Mini-ARC order depends on the full paths."""
    from arcle_tpu.loaders import synthetic as jsyn
    for jax_writer, port_writer, n_files in (
            (jsyn.write_real_layout_fixture, write_real_layout_fixture,
             400 + 400 + 149),
            (jsyn.write_sample_dataset, write_sample_dataset, 16 + 8 + 8)):
        root = tmp_path / "tree"
        want_info = jax_writer(str(root))
        want = _files(root)
        shutil.rmtree(root)
        assert port_writer(str(root)) == want_info
        got = _files(root)
        shutil.rmtree(root)
        assert len(got) == n_files and got == want


def test_arc_loader_full_scale(fixture_tree):
    """400 training + 400 evaluation tasks parse in sorted-glob order;
    ids come from the file names; grids are int8."""
    tr = ARCLoader(train=True, root=fixture_tree["arc_root"])
    ev = ARCLoader(train=False, root=fixture_tree["arc_root"])
    assert len(tr.data) == 400 and len(ev.data) == 400
    ids = [t[-1]["id"] for t in tr.data]
    assert ids == sorted(ids) and all(len(i) == 8 for i in ids)
    for ti, to, ei, eo, _ in tr.data[:20]:
        assert 2 <= len(ti) <= 10 and len(ti) == len(to)
        assert 1 <= len(ei) <= 3 and len(ei) == len(eo)
        for g in ti + to + ei + eo:
            assert g.dtype == np.int8
            assert 1 <= g.shape[0] <= 30 and 1 <= g.shape[1] <= 30
            assert g.min() >= 0 and g.max() <= 9


def test_arc_loader_matches_raw_json(fixture_tree):
    """The loader's output equals a direct json parse of the same file
    (the native baker against the json path)."""
    loader = ARCLoader(train=True, root=fixture_tree["arc_root"])
    paths = sorted(os.path.join(fixture_tree["arc_training"], p)
                   for p in os.listdir(fixture_tree["arc_training"]))
    for k in (0, 57, 399):
        with open(paths[k]) as fp:
            raw = json.load(fp)
        ti, to, ei, eo, desc = loader.data[k]
        assert desc["id"] == os.path.basename(paths[k]).split(".")[0]
        assert len(ti) == len(raw["train"]) and len(eo) == len(raw["test"])
        for g, d in zip(ti, raw["train"]):
            np.testing.assert_array_equal(g, np.array(d["input"], np.int8))
        for g, d in zip(eo, raw["test"]):
            np.testing.assert_array_equal(g, np.array(d["output"], np.int8))


def test_miniarc_loader_null_quirk_and_names(fixture_tree):
    """Files with literal null cells parse (null -> 0 on the raw text);
    ids and descriptions split off the file names as the reference does
    (on '_': the id is the last segment, the description the rest)."""
    loader = MiniARCLoader(root=fixture_tree["miniarc_dir"])
    assert len(loader.data) == 149
    want = [os.path.basename(p).split("_")[-1].split(".")[-2]
            for p in fixture_tree["expected_mini_order"]]
    assert [t[-1]["id"] for t in loader.data] == want
    n_with_desc = 0
    for ti, to, ei, eo, desc in loader.data:
        for g in ti + to + ei + eo:
            assert g.dtype == np.int8 and g.shape == (5, 5) and g.min() >= 0
        n_with_desc += bool(desc["description"])
    assert n_with_desc > 0 and fixture_tree["n_null_files"] == 50


def test_miniarc_null_cells_roundtrip(fixture_tree):
    """A null-bearing file's null cells load as colour 0 in place."""
    mini = fixture_tree["miniarc_dir"]
    null_files = sorted(f for f in os.listdir(mini)
                        if "null" in open(os.path.join(mini, f)).read())
    assert len(null_files) == fixture_tree["n_null_files"]
    fname = null_files[0]
    raw = json.loads(open(os.path.join(mini, fname)).read()
                     .replace("null", "0"))
    tid = fname.split("_")[-1].split(".")[-2]
    task = next(t for t in MiniARCLoader(root=mini).data
                if t[-1]["id"] == tid)
    np.testing.assert_array_equal(task[0][0],
                                  np.array(raw["train"][0]["input"], np.int8))


def test_bake_bank_full_corpus_matches_jax(fixture_tree):
    """The 400-task training split bakes into a bank equal, field for
    field, to ``arcle_tpu``'s bake of the same tree; a pair round-trips
    through it with zero padding."""
    from arcle_tpu.loaders import ARCLoader as JARCLoader
    loader = ARCLoader(train=True, root=fixture_tree["arc_root"])
    bank = loader.bank(device="cpu")
    jbank = JARCLoader(train=True, root=fixture_tree["arc_root"]).bank()
    assert bank.n_tasks == 400
    assert bank.n_pairs == int(bank.train_count.sum() + bank.test_count.sum())
    for f in ("in_grids", "in_dims", "out_grids", "out_dims",
              "train_offset", "train_count", "test_offset", "test_count"):
        np.testing.assert_array_equal(getattr(bank, f).numpy(),
                                      np.asarray(getattr(jbank, f)), f)
    k = 123
    ti, _, _, eo, _ = loader.data[k]
    off = int(bank.train_offset[k])
    g, d = bank.in_grids[off].numpy(), bank.in_dims[off].numpy()
    assert tuple(d) == ti[0].shape
    np.testing.assert_array_equal(g[:d[0], :d[1]], ti[0])
    assert (g[d[0]:, :] == 0).all() and (g[:, d[1]:] == 0).all()
    o = int(bank.test_offset[k])
    od = bank.out_dims[o].numpy()
    np.testing.assert_array_equal(bank.out_grids[o].numpy()[:od[0], :od[1]],
                                  eo[0])


def test_env_var_hooks(fixture_tree, monkeypatch):
    """``ARC_DATA_DIR`` / ``MINIARC_DATA_DIR`` point the default
    constructors at a tree in the real layouts."""
    monkeypatch.setenv("ARC_DATA_DIR", fixture_tree["arc_root"])
    monkeypatch.setenv("MINIARC_DATA_DIR", fixture_tree["miniarc_dir"])
    assert len(ARCLoader(train=False).data) == 400
    assert len(MiniARCLoader().data) == 149
