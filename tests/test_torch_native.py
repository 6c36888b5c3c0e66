"""The port's native C++ baker and single-env engine
(``arcle_tpu_torch.native``, built from ``arcle_tpu_torch/csrc/*.cpp``).

The baker against ``json`` on the bundled datasets and against
``arcle_tpu``'s loaders; the engine fuzzed against the port's NumPy
oracle over the six op families; concurrent first builds.  A test skips
only where ``g++`` is missing: where it exists, a failed build fails.
"""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from arcle_tpu.loaders import ARCLoader as JARCLoader
from arcle_tpu.loaders import MiniARCLoader as JMiniARCLoader

from arcle_tpu_torch import native
from arcle_tpu_torch.loaders import ARCLoader, MiniARCLoader, make_tasks
from arcle_tpu_torch.ops import arc_table, o2arc_table, raw_table
from arcle_tpu_torch.oracle import OracleEnv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "arcle_tpu", "data")

FAMILIES = [
    ("raw", lambda: raw_table(-1), -1),
    ("arc", lambda: arc_table(-1), -1),
    ("o2arc", lambda: o2arc_table(-1), -1),
    ("o2arc", lambda: o2arc_table(3), 3),
    ("o2arc_crop33", lambda: o2arc_table(127, crop_at_33=True), 127),
    ("o2arc_nofill", lambda: o2arc_table(-1, no_fill=True), -1),
]


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native libraries cannot be built")


def _json_task(text):
    problem = json.loads(text)
    return [[(np.array(d["input"], np.int8), np.array(d["output"], np.int8))
             for d in problem[split]] for split in ("train", "test")]


@pytest.mark.parametrize("pattern,null_quirk", [
    ("sample_arc/training/*.json", False),
    ("sample_arc/evaluation/*.json", False),
    ("sample_miniarc/*.json", True)])
def test_bake_matches_json_on_bundled(gxx, pattern, null_quirk):
    paths = sorted(glob.glob(os.path.join(DATA, pattern)))
    assert paths
    for p in paths:
        with open(p) as fp:
            text = fp.read()
        if null_quirk:
            text = text.replace("null", '"0"')
        baked = native.bake_task_native(text)
        assert baked is not None, p
        for got, want in zip(baked, _json_task(text)):
            assert len(got) == len(want), p
            for (gi, go), (wi, wo) in zip(got, want):
                for g, w in ((gi, wi), (go, wo)):
                    assert g.dtype == np.int8
                    np.testing.assert_array_equal(g, w, err_msg=p)


def test_bake_matches_json_on_synthetic(gxx):
    for ti, to, ei, eo, _ in make_tasks(6, seed=11, max_size=30):
        text = json.dumps({
            "train": [{"input": i.tolist(), "output": o.tolist()}
                      for i, o in zip(ti, to)],
            "test": [{"input": i.tolist(), "output": o.tolist()}
                     for i, o in zip(ei, eo)]})
        train, test = native.bake_task_native(text)
        for got, ins, outs in ((train, ti, to), (test, ei, eo)):
            assert len(got) == len(ins)
            for (gi, go), ri, ro in zip(got, ins, outs):
                np.testing.assert_array_equal(gi, ri)
                np.testing.assert_array_equal(go, ro)


def test_loaders_match_arcle_tpu(gxx):
    """The port's loaders (native baker) give arcle_tpu's loaders' data:
    ARC training and evaluation, and Mini-ARC with its null quirk."""
    assert native.available()
    pairs = [(ARCLoader(train=True), JARCLoader(train=True)),
             (ARCLoader(train=False), JARCLoader(train=False)),
             (MiniARCLoader(), JMiniARCLoader())]
    for ours, ref in pairs:
        assert len(ours.data) == len(ref.data) > 0
        for a, b in zip(ours.data, ref.data):
            for la, lb in zip(a[:4], b[:4]):
                assert len(la) == len(lb)
                for x, y in zip(la, lb):
                    assert x.dtype == y.dtype == np.int8
                    np.testing.assert_array_equal(x, y)
            assert a[4] == b[4]


def test_bake_null_quirk_and_garbage(gxx):
    text = ('{"train": [{"input": [[null, 1]], "output": [["0", 2]]}], '
            '"test": []}')
    train, test = native.bake_task_native(text)
    np.testing.assert_array_equal(train[0][0], [[0, 1]])
    np.testing.assert_array_equal(train[0][1], [[0, 2]])
    assert test == []
    assert native.bake_task_native("not json at all") in (None, ([], []))
    # a grid wider than 30 is refused, and the loader's json path takes it
    wide = json.dumps({"train": [{"input": [[1] * 31], "output": [[2]]}],
                       "test": []})
    assert native.bake_task_native(wide) is None


def test_no_compiler_means_unavailable(monkeypatch, tmp_path):
    """Without g++ (and no built library) the baker is unavailable, the
    loaders fall back to json, and NativeEngine raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_failed", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    assert not native.engine_available()
    assert native.bake_task_native('{"train": [], "test": []}') is None
    assert len(ARCLoader().data) == 16
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        native.NativeEngine(o2arc_table(-1))


def _random_action(rng, n_ops, H=30, W=30):
    kind = rng.integers(0, 4)
    sel = np.zeros((H, W), np.int8)
    if kind == 1:
        sel[rng.integers(0, H), rng.integers(0, W)] = 1
    elif kind >= 2:
        x1, x2 = sorted(rng.integers(0, H, 2).tolist())
        y1, y2 = sorted(rng.integers(0, W, 2).tolist())
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    return sel, int(rng.integers(0, n_ops))


def assert_state_equal(got, want, what):
    for k in ("trials_remain", "terminated", "input", "input_dim", "grid",
              "grid_dim", "selected", "clip", "clip_dim"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
        assert got[k].dtype == want[k].dtype, (what, k)
    for k, v in want["object_states"].items():
        np.testing.assert_array_equal(got["object_states"][k], v,
                                      err_msg=f"{what} object_states.{k}")
    assert got["_submit_count"] == want["_submit_count"], what
    assert got["_steps"] == want["_steps"], what


@pytest.mark.parametrize("fam,make_table,max_trial", FAMILIES,
                         ids=[f"{f[0]}-mt{f[2]}" for f in FAMILIES])
def test_engine_fuzz_vs_oracle(gxx, fam, make_table, max_trial):
    table = make_table()
    rng = np.random.default_rng(100 + FAMILIES.index(
        (fam, make_table, max_trial)))
    for trial in range(3):
        inp = rng.integers(0, 10, (int(rng.integers(2, 13)),
                                   int(rng.integers(2, 13)))).astype(np.int8)
        out = rng.integers(0, 10, (int(rng.integers(2, 13)),
                                   int(rng.integers(2, 13)))).astype(np.int8)
        ros = trial == 2
        eng = native.NativeEngine(table, max_trial=max_trial)
        eng.reset(inp, out, reset_on_submit=ros)
        orc = OracleEnv(fam, max_trial=max_trial)
        orc.reset(inp, out, reset_on_submit=ros)
        for t in range(120):
            sel, op = _random_action(rng, table.n_ops)
            r_n, term_n = eng.step(sel, op)
            _, r_o, term_o = orc.step(sel, op)
            assert (r_n, term_n) == (r_o, term_o), (fam, t, op)
            assert_state_equal(eng.state_dict(), orc.state,
                               f"{fam} trial {trial} step {t} op {op}")


def test_engine_scripted_solve(gxx):
    """Colour the grid into the answer, then Submit: reward 1.0."""
    table = o2arc_table(-1)
    eng = native.NativeEngine(table, max_trial=-1)
    eng.reset(np.zeros((3, 3), np.int8), np.full((3, 3), 4, np.int8))
    sel = np.zeros((30, 30), np.int8)
    sel[:3, :3] = 1
    assert eng.step(sel, 4) == (0.0, False)
    assert eng.step(np.zeros((30, 30), np.int8), table.n_ops - 1) == \
        (1.0, True)
    assert eng.submit_count == 1


def test_engine_run_matches_steps(gxx):
    table = o2arc_table(-1)
    rng = np.random.default_rng(3)
    inp = rng.integers(0, 10, (8, 8)).astype(np.int8)
    out = rng.integers(0, 10, (8, 8)).astype(np.int8)
    n = 200
    sels = np.zeros((n, 30, 30), np.int8)
    ops = np.zeros(n, np.int64)
    for i in range(n):
        sels[i], ops[i] = _random_action(rng, table.n_ops)
    a, b = (native.NativeEngine(table, max_trial=-1) for _ in range(2))
    a.reset(inp, out)
    b.reset(inp, out)
    rew_a, term_a = a.run(sels, ops)
    steps = [b.step(sels[i], ops[i]) for i in range(n)]
    np.testing.assert_array_equal(rew_a, [r for r, _ in steps])
    np.testing.assert_array_equal(term_a, [t for _, t in steps])
    assert_state_equal(a.state_dict(), b.state_dict(), "run vs step")


def test_engine_small_frame(gxx):
    """A 5x5 frame (the Mini-ARC interactive setting)."""
    eng = native.NativeEngine(raw_table(-1), H=5, W=5, max_trial=-1)
    eng.reset(np.arange(25, dtype=np.int8).reshape(5, 5) % 10,
              (np.arange(25, dtype=np.int8).reshape(5, 5) + 1) % 10)
    eng.step(np.ones((5, 5), np.int8), 7)
    sd = eng.state_dict()
    assert sd["grid"].shape == (5, 5) and (sd["grid"] == 7).all()
    with pytest.raises(ValueError, match="selection"):
        eng.step(np.ones((30, 30), np.int8), 7)
    with pytest.raises(ValueError, match="exceed"):
        native.NativeEngine(raw_table(-1), H=31, W=31)


_BUILDER = """
import ctypes, importlib.util, pathlib, sys, time
# the module alone (numpy and the standard library), so a builder starts
# in a fraction of a second and the three compile at the same moment
spec = importlib.util.spec_from_file_location(
    "native_alone", "arcle_tpu_torch/native/__init__.py")
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
out, me, rounds = pathlib.Path(sys.argv[1]), sys.argv[2], int(sys.argv[3])
for r in range(rounds):
    (out / f"ready-{r}-{me}").touch()
    t0 = time.time()
    while len(list(out.glob(f"ready-{r}-*"))) < 3:
        if time.time() - t0 > 30:
            sys.exit("the other builders never came")
        time.sleep(0.001)
    for name in ("engine", "bake"):
        path, _ = native.build(name, out / f"build-{r}")
        lib = ctypes.CDLL(str(path))
        if name == "engine":
            lib.engine_state_size.restype = ctypes.c_int
            assert lib.engine_state_size() == ctypes.sizeof(native._CState)
print("loaded")
"""


def test_concurrent_first_builds(gxx, tmp_path):
    """Three processes build both libraries into one fresh build directory
    at once (after a barrier), and each loads them; four rounds, each in a
    fresh directory."""
    rounds = 4
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                               str(tmp_path), str(i), str(rounds)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded"
    for r in range(rounds):
        built = sorted(f.name for f in (tmp_path / f"build-{r}").iterdir())
        assert len(built) == 2 and all(f.endswith(".so") for f in built), \
            built


def test_package_data_ships_every_source():
    """A non-editable install carries every source the port builds at run
    time: the step kernel's ``.cu`` and the native ``.cpp`` files."""
    import fnmatch
    import tomllib
    from pathlib import Path

    from arcle_tpu_torch.ops import step_kernel

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "arcle_tpu_torch"]
    pkg = Path(native.__file__).resolve().parents[1]
    read = [step_kernel.SOURCE] + [native.CSRC / f"{name}.cpp"
                                   for name in ("engine", "bake")]
    for src in read + sorted(native.CSRC.iterdir()):
        assert src.exists(), src
        rel = src.resolve().relative_to(pkg).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), \
            f"{rel} is not named by package-data {globs}"
