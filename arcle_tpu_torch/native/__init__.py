"""Native (C++) host-side components, loaded with ctypes.

Counterpart of ``arcle_tpu/native/__init__.py``, built from the port's own
copies of its sources (``csrc/bake.cpp``, ``csrc/engine.cpp``):

* :func:`bake_task_native` parses one ARC task JSON (the loaders try it
  first and fall back to ``json``);
* :class:`NativeEngine` is the single-env transition on the host, the
  gym adapters' ``backend="native"``.

Each library is compiled with ``g++`` at first use into ``_build/``, its
file name keyed by a hash of the source and flags.  The compiler writes a
temporary file of its own process, which is then renamed into place, so
processes that build at once (test workers) never load a half-written
library.  Without a compiler :func:`available` and
:func:`engine_available` are False and :class:`NativeEngine` raises.
Nothing is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_failed: Dict[str, str] = {}       # library -> why its build or load failed


def build(name: str, build_dir: Optional[Path] = None
          ) -> Tuple[Path, float]:
    """Compile ``csrc/<name>.cpp`` into ``build_dir`` (default
    :data:`BUILD_DIR`) unless a build of this source exists there.

    Returns ``(library path, seconds spent compiling)``; the seconds are
    0.0 when the library was already built.  Raises if ``g++`` fails.
    """
    src = CSRC / f"{name}.cpp"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = Path(build_dir or BUILD_DIR) / f"lib{name}_{key}.so"
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib, time.perf_counter() - t0


def _load(name: str, bind) -> Optional[ctypes.CDLL]:
    """Build (once per process) and load library ``name``, declaring its
    functions with ``bind``; None if the build or the load failed."""
    with _lock:
        if name in _libs or name in _failed:
            return _libs.get(name)
        try:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            bind(lib)
        except (OSError, subprocess.SubprocessError, AssertionError) as e:
            _failed[name] = f"{type(e).__name__}: {e}"
            return None
        _libs[name] = lib
        return lib


def _bind_bake(lib: ctypes.CDLL) -> None:
    lib.bake_task.restype = ctypes.c_int
    lib.bake_task.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]


def available() -> bool:
    """Whether the native baker builds and loads here."""
    return _load("bake", _bind_bake) is not None


def bake_task_native(text: str, max_pairs: int = 256):
    """Parse one ARC task JSON with the C++ baker.

    Returns ``(train_pairs, test_pairs)`` where each pair is
    ``(input_grid, output_grid)`` of *unpadded* int8 arrays, or None if the
    native path is unavailable or the text does not parse.
    """
    lib = _load("bake", _bind_bake)
    if lib is None:
        return None
    raw = text.encode()
    grids = np.zeros((max_pairs, 2, 900), np.int8)
    dims = np.zeros((max_pairs, 2, 2), np.int32)
    splits = np.zeros((max_pairs,), np.int32)
    n = lib.bake_task(
        raw, len(raw),
        grids.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        splits.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_pairs)
    if n < 0:
        return None
    train, test = [], []
    for i in range(n):
        hi, wi = int(dims[i, 0, 0]), int(dims[i, 0, 1])
        ho, wo = int(dims[i, 1, 0]), int(dims[i, 1, 1])
        pair = (grids[i, 0].reshape(30, 30)[:hi, :wi].copy(),
                grids[i, 1].reshape(30, 30)[:ho, :wo].copy())
        (train if splits[i] == 0 else test).append(pair)
    return train, test


# ---------------------------------------------------------------------------
# The single-env engine (engine.cpp)
# ---------------------------------------------------------------------------
_MAXP = 900


class _CState(ctypes.Structure):
    """Mirror of ``NativeState`` in engine.cpp (field order and types must
    match exactly; sizeof is checked against ``engine_state_size()``)."""

    _fields_ = [
        ("input", ctypes.c_int8 * _MAXP),
        ("grid", ctypes.c_int8 * _MAXP),
        ("selected", ctypes.c_int8 * _MAXP),
        ("clip", ctypes.c_int8 * _MAXP),
        ("object", ctypes.c_int8 * _MAXP),
        ("object_sel", ctypes.c_int8 * _MAXP),
        ("background", ctypes.c_int8 * _MAXP),
        ("answer", ctypes.c_int8 * _MAXP),
        ("input_dim", ctypes.c_int32 * 2),
        ("grid_dim", ctypes.c_int32 * 2),
        ("clip_dim", ctypes.c_int32 * 2),
        ("object_dim", ctypes.c_int32 * 2),
        ("object_pos", ctypes.c_int32 * 2),
        ("answer_dim", ctypes.c_int32 * 2),
        ("active", ctypes.c_int32),
        ("rotation_parity", ctypes.c_int32),
        ("trials_remain", ctypes.c_int8),
        ("terminated", ctypes.c_int32),
        ("reset_on_submit", ctypes.c_int32),
        ("max_trial", ctypes.c_int32),
        ("submit_count", ctypes.c_int32),
        ("steps", ctypes.c_int32),
        ("last_action_op", ctypes.c_int32),
        ("last_reward", ctypes.c_float),
        ("H", ctypes.c_int32),
        ("W", ctypes.c_int32),
    ]


def _bind_engine(lib: ctypes.CDLL) -> None:
    lib.engine_state_size.restype = ctypes.c_int
    lib.engine_state_size.argtypes = []
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.engine_reset.restype = None
    lib.engine_reset.argtypes = [
        ctypes.POINTER(_CState), i8p, ctypes.c_int, ctypes.c_int,
        i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.engine_step.restype = ctypes.c_int
    lib.engine_step.argtypes = [
        ctypes.POINTER(_CState), i8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.engine_run.restype = ctypes.c_int
    lib.engine_run.argtypes = [
        ctypes.POINTER(_CState), i8p, i32p, i32p, i32p, i32p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), i8p]
    if lib.engine_state_size() != ctypes.sizeof(_CState):
        raise AssertionError(
            f"engine.cpp's state is {lib.engine_state_size()} bytes, "
            f"_CState {ctypes.sizeof(_CState)}")


def _load_engine() -> Optional[ctypes.CDLL]:
    return _load("engine", _bind_engine)


def engine_available() -> bool:
    """Whether the native engine builds and loads here."""
    return _load_engine() is not None


class NativeEngine:
    """The C++ single-env engine behind the oracle's step surface.

    Table-driven like the batched engine: any
    :class:`~arcle_tpu_torch.ops.table.OpTable` family runs through the one
    compiled transition.  Grids of up to 30x30.
    """

    def __init__(self, table, H: int = 30, W: int = 30,
                 max_trial: int = -1):
        if not (0 < H <= 30 and 0 < W <= 30):
            raise ValueError(f"native engine: {H}x{W} grids exceed 30x30")
        lib = _load_engine()
        if lib is None:
            raise RuntimeError("native engine unavailable (g++ build "
                               f"failed: {_failed.get('engine')})")
        self._lib = lib
        self.table = table
        self.H, self.W = H, W
        self.max_trial = max_trial
        self._st = _CState()
        n = table.n_ops
        self._grp = np.asarray(table.group, np.int32)
        self._par = np.asarray(table.param, np.int32)
        self._rs = np.asarray(table.reset_sel, np.int32)
        self._is_sub = (np.arange(n) == table.submit_op).astype(np.int32)
        # per-op python-int rows and reusable ctypes out-params: the
        # per-step call converts no numpy scalar
        self._rows = [(int(self._grp[i]), int(self._par[i]),
                       int(self._rs[i]), int(self._is_sub[i]))
                      for i in range(n)]
        self._rew = ctypes.c_float(0.0)
        self._rew_ref = ctypes.byref(self._rew)
        self._st_ref = ctypes.byref(self._st)
        self._i8p = ctypes.POINTER(ctypes.c_int8)
        # zero-copy numpy views over the state buffer, built once: the
        # adapters return them as observations (the reference likewise
        # exposes its live mutable state dict)
        P = H * W
        gv = lambda name: np.ctypeslib.as_array(
            getattr(self._st, name))[:P].reshape(H, W)
        self._v = {k: gv(k) for k in
                   ("input", "grid", "selected", "clip", "object",
                    "object_sel", "background")}
        for k in ("input_dim", "grid_dim", "clip_dim", "object_dim",
                  "object_pos"):
            self._v[k] = np.ctypeslib.as_array(getattr(self._st, k))
        self._obs_cache = None

    @property
    def n_ops(self) -> int:
        return self.table.n_ops

    @property
    def submit_count(self) -> int:
        return int(self._st.submit_count)

    def reset(self, input_grid: np.ndarray, answer: np.ndarray,
              reset_on_submit: bool = False) -> None:
        inp = np.ascontiguousarray(input_grid, np.int8)
        ans = np.ascontiguousarray(answer, np.int8)
        self._lib.engine_reset(
            self._st_ref,
            inp.ctypes.data_as(self._i8p), inp.shape[0], inp.shape[1],
            ans.ctypes.data_as(self._i8p), ans.shape[0], ans.shape[1],
            self.max_trial, int(reset_on_submit), self.H, self.W)

    def step(self, selection: np.ndarray, operation: int):
        """One transition; returns ``(reward, terminated)``."""
        sel = np.ascontiguousarray(selection, np.int8)
        if sel.size != self.H * self.W:
            raise ValueError(f"selection of shape {sel.shape} for a "
                             f"{self.H}x{self.W} engine")
        op = int(operation)
        g, p, rsf, sub = self._rows[op]
        term = self._lib.engine_step(
            self._st_ref, ctypes.cast(sel.ctypes.data, self._i8p),
            g, p, rsf, sub, self._rew_ref)
        self._st.last_action_op = op
        return float(self._rew.value), bool(term)

    def run(self, selections: np.ndarray, operations: np.ndarray):
        """Step a whole action sequence in one call; returns ``(rewards f32
        [n], terminated bool [n])``."""
        n = len(operations)
        sels = np.ascontiguousarray(
            np.asarray(selections).reshape(n, self.H * self.W), np.int8)
        ops = np.asarray(operations, np.int32)
        grp = np.ascontiguousarray(self._grp[ops])
        par = np.ascontiguousarray(self._par[ops])
        rs = np.ascontiguousarray(self._rs[ops])
        sub = np.ascontiguousarray(self._is_sub[ops])
        rew = np.zeros(n, np.float32)
        term = np.zeros(n, np.int8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.engine_run(
            self._st_ref, sels.ctypes.data_as(self._i8p),
            grp.ctypes.data_as(i32p), par.ctypes.data_as(i32p),
            rs.ctypes.data_as(i32p), sub.ctypes.data_as(i32p),
            n, rew.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            term.ctypes.data_as(self._i8p))
        if n:
            self._st.last_action_op = int(ops[-1])
        return rew, term.astype(bool)

    def observation(self, keys=()) -> dict:
        """Zero-copy observation dict in the reference layout.  The grids
        are *views* of the engine state and the small arrays are buffers
        updated in place: the next step changes them, as the reference's
        ``current_state`` does.  ``keys``: include the "clip" and
        "selected" groups."""
        s, v = self._st, self._v
        if self._obs_cache is None:
            i8 = lambda n: np.zeros(n, np.int8)
            obs = {"trials_remain": i8(1), "terminated": i8(1),
                   "input": v["input"], "input_dim": i8(2),
                   "grid": v["grid"], "grid_dim": i8(2)}
            if "clip" in keys:
                obs["clip"] = v["clip"]
                obs["clip_dim"] = i8(2)
            if "selected" in keys:
                obs["selected"] = v["selected"]
                obs["object_states"] = {
                    "active": i8(1), "object": v["object"],
                    "object_sel": v["object_sel"], "object_dim": i8(2),
                    "object_pos": i8(2), "background": v["background"],
                    "rotation_parity": i8(1)}
            self._obs_cache = obs
        obs = self._obs_cache
        obs["trials_remain"][0] = s.trials_remain
        obs["terminated"][0] = s.terminated
        obs["input_dim"][:] = v["input_dim"]
        obs["grid_dim"][:] = v["grid_dim"]
        if "clip" in keys:
            obs["clip_dim"][:] = v["clip_dim"]
        if "selected" in keys:
            od = obs["object_states"]
            od["active"][0] = s.active
            od["object_dim"][:] = v["object_dim"]
            od["object_pos"][:] = v["object_pos"]
            od["rotation_parity"][0] = s.rotation_parity
        return obs

    def state_dict(self) -> dict:
        """Snapshot in the oracle's state layout."""
        s, v = self._st, self._v
        dim = lambda k: v[k].astype(np.int8)
        return {
            "trials_remain": np.array([s.trials_remain], np.int8),
            "terminated": np.array([s.terminated], np.int8),
            "input": v["input"].copy(),
            "input_dim": dim("input_dim"),
            "grid": v["grid"].copy(),
            "grid_dim": dim("grid_dim"),
            "selected": v["selected"].copy(),
            "clip": v["clip"].copy(),
            "clip_dim": dim("clip_dim"),
            "object_states": {
                "active": np.array([s.active], np.int8),
                "object": v["object"].copy(),
                "object_sel": v["object_sel"].copy(),
                "object_dim": dim("object_dim"),
                "object_pos": dim("object_pos"),
                "background": v["background"].copy(),
                "rotation_parity": np.array([s.rotation_parity], np.int8),
            },
            "_submit_count": s.submit_count,
            "_steps": s.steps,
        }


__all__ = ["available", "bake_task_native", "build", "engine_available",
           "NativeEngine"]
