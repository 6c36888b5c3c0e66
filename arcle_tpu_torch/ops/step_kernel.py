"""The whole-transition step kernel for Hopper, its wrapper and its plain
version.

Counterpart of ``arcle_tpu/ops/pallas_step.py``.  The kernel
(``csrc/step_kernel.cu``) runs one env's whole transition per thread block
and folds in the reward / bookkeeping epilogue; it finishes flood fills
exactly, so the ``pending`` it returns is always False.

The source is compiled with ``nvcc`` at first use into ``_build/`` (keyed
by a hash of the source and flags) as a shared library with a plain C
interface, and loaded with ``ctypes``.  Nothing is compiled or loaded at
import time.

* :func:`cuda_step_deferred` launches the kernel for CUDA tensors, or
  raises; for CPU tensors it runs :func:`plain_step_deferred`.
* :func:`plain_step_deferred` is the batched plain PyTorch transition of
  ``ops/table.py``; with :func:`~arcle_tpu_torch.ops.table.finish_flood` it
  is the spec the kernel is held to.
* ``LAUNCHES`` counts kernel launches (not plain calls).

The kernel treats ``input`` as read-only: a reset-on-submit re-init keeps
the state's ``input`` tensor, which ``init_state`` leaves zero outside
``input_dim``, so it equals the re-initialised input of the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..core.state import EnvState, Action, I8, I32, F32
from .groups import G
from .table import OpTable, step_deferred

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "step_kernel.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_CELLS = 1024          # kernel: 256 threads x 4 cells

LAUNCHES = 0              # kernel launches since import (or the last reset)

_lib: Optional[ctypes.CDLL] = None
_table_rows: Dict[Tuple[OpTable, torch.device], torch.Tensor] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the step kernel builds only "
                           "where the CUDA toolkit is installed")
    return path


def build() -> Tuple[Path, float, str]:
    """Compile the kernel unless a build of this source exists.

    Returns ``(library path, seconds spent compiling, compiler output)``;
    the seconds are 0.0 when the library was already built.
    """
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libstep_kernel_{key}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib, seconds, log


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.arcle_step_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def plain_step_deferred(state: EnvState, action: Action, table: OpTable):
    """The plain PyTorch step with deferred flood fill (``ops.table``):
    returns ``(state, reward, terminated, pending)``."""
    return step_deferred(state, action, table)


def _rows_on(table: OpTable, device: torch.device) -> torch.Tensor:
    key = (table, device)
    if key not in _table_rows:
        _table_rows[key] = table.rows(device)
    return _table_rows[key]


_GRID_IN = ("grid", "input", "answer", "selected", "clip", "object",
            "object_sel", "background")
_DIM_IN = ("grid_dim", "input_dim", "answer_dim", "clip_dim", "object_dim",
           "object_pos")
_FLAG_IN = ("trials_remain", "terminated", "active", "rotation_parity",
            "reset_on_submit")
_COUNT_IN = ("steps", "submit_count")
_GRID_OUT = ("grid", "selected", "clip", "object", "object_sel",
             "background")
_DIM_OUT = ("grid_dim", "clip_dim", "object_dim", "object_pos")
_FLAG_OUT = ("trials_remain", "terminated", "active", "rotation_parity")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def cuda_step_deferred(state: EnvState, action: Action, table: OpTable):
    """One batched step through the CUDA kernel.

    Returns ``(state, reward, terminated, pending)`` like
    :func:`plain_step_deferred`, with the flood fill already complete
    (``pending`` all False).  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and anything the kernel does not take
    raises.
    """
    global LAUNCHES
    dev = state.grid.device
    if dev.type == "cpu":
        return plain_step_deferred(state, action, table)
    if dev.type != "cuda":
        raise ValueError(f"step kernel: unsupported device {dev}")
    B, H, W = state.grid.shape
    if H * W > MAX_CELLS:
        raise ValueError(f"step kernel: {H}x{W} grids exceed {MAX_CELLS} "
                         "cells")
    if G.OBJECT in table.group and H != W:
        raise ValueError("step kernel: object ops need square grids")

    for name in _GRID_IN:
        _check(name, getattr(state, name), I8, (B, H, W), dev)
    for name in _DIM_IN:
        _check(name, getattr(state, name), I8, (B, 2), dev)
    for name in _FLAG_IN:
        _check(name, getattr(state, name), I8, (B,), dev)
    for name in _COUNT_IN:
        _check(name, getattr(state, name), I32, (B,), dev)
    _check("selection", action.selection, I8, (B, H, W), dev)
    _check("operation", action.operation, I32, (B,), dev)

    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        result = _launch(lib, state, action, table, _rows_on(table, dev),
                         stream)
    LAUNCHES += 1
    return result


def _launch(lib: ctypes.CDLL, state: EnvState, action: Action,
            table: OpTable, rows: torch.Tensor, stream):
    """Allocate the outputs beside ``state`` and launch the kernel of
    ``lib`` on ``stream``; the inputs are already checked."""
    B, H, W = state.grid.shape
    dev = state.grid.device
    out = {name: torch.empty((B, H, W), dtype=I8, device=dev)
           for name in _GRID_OUT}
    out.update({name: torch.empty((B, 2), dtype=I8, device=dev)
                for name in _DIM_OUT})
    out.update({name: torch.empty((B,), dtype=I8, device=dev)
                for name in _FLAG_OUT})
    out.update({name: torch.empty((B,), dtype=I32, device=dev)
                for name in ("steps", "submit_count", "last_action_op")})
    reward = torch.empty((B,), dtype=F32, device=dev)
    term = torch.empty((B,), dtype=torch.bool, device=dev)
    pending = torch.empty((B,), dtype=torch.bool, device=dev)

    ins = [getattr(state, n) for n in _GRID_IN] + [action.selection] + \
        [getattr(state, n) for n in _DIM_IN + _FLAG_IN + _COUNT_IN] + \
        [action.operation, rows]
    outs = [out[n] for n in _GRID_OUT + _DIM_OUT + _FLAG_OUT] + \
        [out["steps"], out["submit_count"], out["last_action_op"], reward,
         term, pending]
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    err = lib.arcle_step_launch(in_ptrs, out_ptrs, B, H, W, table.n_ops,
                                table.max_trial, table.submit_op, stream)
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    s2 = state.replace(last_reward=reward, **out)
    return s2, reward, term, pending
