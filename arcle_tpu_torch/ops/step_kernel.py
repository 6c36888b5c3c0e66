"""The whole-transition step kernel for Hopper, its wrapper and its plain
version.

Counterpart of ``arcle_tpu/ops/pallas_step.py``.  The kernel
(``csrc/step_kernel.cu``) runs one env's whole transition per warp and
folds in the reward / bookkeeping epilogue; it finishes flood fills
exactly, so the ``pending`` it returns is always False.  Its 20 outputs
are views of one device arena, each contiguous, with the dtype and shape
of the plain version's, and each starting on a 256-byte boundary.

The source is compiled with ``nvcc`` at first use into ``_build/`` (keyed
by a hash of the source and flags) as a shared library with a plain C
interface, and loaded with ``ctypes``.  Nothing is compiled or loaded at
import time.

* :func:`cuda_step_deferred` launches the kernel for CUDA tensors, or
  raises; for CPU tensors it runs :func:`plain_step_deferred`.
* :func:`plain_step_deferred` is the batched plain PyTorch transition of
  ``ops/table.py``; with :func:`~arcle_tpu_torch.ops.table.finish_flood` it
  is the spec the kernel is held to.
* :func:`complete_step` is one whole step on either device: the kernel, or
  the plain step with its deferred floods finished.  The batched engine
  and the single-env engine both step through it.
* ``LAUNCHES`` counts kernel launches (not plain calls).
* :func:`step_epilogue` is the rest of ``BatchedEnv.step``: reward shaping,
  terminate-on-match, truncation and the auto-reset merge.  For CUDA
  tensors it launches the engine epilogue kernel of the same source (one
  launch a step; its outputs are views of one arena, laid out as the step
  kernel's), or raises; for CPU tensors it runs the env's plain version,
  ``BatchedEnv.plain_epilogue``.  ``EPILOGUE_LAUNCHES`` counts its
  launches.

The kernel treats ``input`` as read-only: a reset-on-submit re-init keeps
the state's ``input`` tensor, which ``init_state`` leaves zero outside
``input_dim``, so it equals the re-initialised input of the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..core.state import EnvState, Action, I8, I32, F32
from .groups import G
from .table import OpTable, finish_flood, step_deferred

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "step_kernel.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_CELLS = 1024          # kernel: one warp's shared rows per env

LAUNCHES = 0              # kernel launches since import (or the last reset)
EPILOGUE_LAUNCHES = 0     # engine epilogue launches, likewise

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
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        epi = lib.arcle_epilogue_launch
        epi.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p]
        epi.restype = ctypes.c_int
        occ = lib.arcle_step_resident_warps
        occ.argtypes = [ctypes.c_int, ctypes.c_int]
        occ.restype = ctypes.c_int
        _lib = lib
    return _lib


def resident_warps(H: int = 30, W: int = 30) -> int:
    """Envs (one warp each) that one SM holds at once for ``H x W`` grids,
    as the CUDA occupancy calculator gives it for the kernel's build."""
    n = load().arcle_step_resident_warps(H, W)
    if n < 0:
        raise RuntimeError("step kernel: occupancy query failed")
    return n


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
    if t.device == device and t.dtype == dtype and t.shape == shape and \
            t.is_contiguous():
        return
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

    grid_shape = (B, H, W)
    for name in _GRID_IN:
        _check(name, getattr(state, name), I8, grid_shape, dev)
    for name in _DIM_IN:
        _check(name, getattr(state, name), I8, (B, 2), dev)
    for name in _FLAG_IN:
        _check(name, getattr(state, name), I8, (B,), dev)
    for name in _COUNT_IN:
        _check(name, getattr(state, name), I32, (B,), dev)
    _check("selection", action.selection, I8, grid_shape, dev)
    _check("operation", action.operation, I32, (B,), dev)

    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        result = _launch(lib, state, action, table, _rows_on(table, dev),
                         stream)
    LAUNCHES += 1
    return result


def complete_step(state: EnvState, action: Action, table: OpTable):
    """One whole step: :func:`cuda_step_deferred`, and on the CPU the
    deferred flood fills finished.  Returns ``(state, reward,
    terminated)``.  The kernel finishes flood fills itself, so on CUDA the
    host is asked nothing; the plain path asks whether any env is
    pending."""
    with TRACE.span("step_kernel"):
        state2, reward, term, pending = cuda_step_deferred(state, action,
                                                           table)
        if not state2.grid.is_cuda and bool(pending.any()):
            state2 = finish_flood(state2, action, table, pending)
        return state2, reward, term


# The outputs in the kernel's order, by kind: names, dtype, and the shape
# after the batch axis (None: the grid's).  The reward is also the state's
# `last_reward`; `_term` and `_pending` are returned beside the state.
_OUT_KINDS = ((_GRID_OUT, I8, None), (_DIM_OUT, I8, (2,)),
              (_FLAG_OUT, I8, ()),
              (("steps", "submit_count", "last_action_op"), I32, ()),
              (("last_reward",), F32, ()),
              (("_term", "_pending"), torch.bool, ()))


def _pad(n: int) -> int:
    return -(-n // 256) * 256


@functools.lru_cache(maxsize=64)
def _layout(B: int, H: int, W: int, out_kinds=_OUT_KINDS):
    """Where the outputs of ``out_kinds`` (the step kernel's 20 by default)
    lie in one byte arena, each on a 256-byte boundary.  Returns ``(arena
    bytes, the kernel's int64 offsets, [(names, dtype, shape, strides,
    start, stride)])``: the outputs of one kind are ``stride`` bytes apart
    from ``start`` on."""
    kinds, offsets, at = [], [], 0
    for names, dtype, tail in out_kinds:
        shape = (B,) + ((H, W) if tail is None else tail)
        strides = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        stride = _pad(math.prod(shape) * dtype.itemsize)
        kinds.append((names, dtype, shape, strides, at, stride))
        offsets += [at + k * stride for k in range(len(names))]
        at += stride * len(names)
    return at, (ctypes.c_int64 * len(offsets))(*offsets), kinds


def _views(arena: torch.Tensor, kinds) -> Dict[str, torch.Tensor]:
    """The outputs of a layout's ``kinds`` as views of ``arena``, by
    name."""
    out = {}
    for names, dtype, shape, strides, start, stride in kinds:
        size = dtype.itemsize
        views = arena.view(dtype).as_strided(
            (len(names),) + shape, (stride // size,) + strides,
            start // size).unbind(0)
        out.update(zip(names, views))
    return out


def _launch(lib: ctypes.CDLL, state: EnvState, action: Action,
            table: OpTable, rows: torch.Tensor, stream):
    """Allocate the outputs as views of one arena beside ``state`` and
    launch the kernel of ``lib`` on ``stream``; the inputs are already
    checked."""
    B, H, W = state.grid.shape
    total, offsets, kinds = _layout(B, H, W)
    ins = [getattr(state, n) for n in _GRID_IN] + [action.selection] + \
        [getattr(state, n) for n in _DIM_IN + _FLAG_IN + _COUNT_IN] + \
        [action.operation, rows]
    ptrs = [t.data_ptr() for t in ins]
    if (H, W) == (30, 30) and any(p & 3 for p in ptrs[:9]):
        raise ValueError("step kernel: a grid does not start on a 4-byte "
                         "boundary")
    in_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)

    arena = torch.empty(total, dtype=torch.uint8, device=state.grid.device)
    out = _views(arena, kinds)
    err = lib.arcle_step_launch(in_ptrs, arena.data_ptr(), offsets, B, H, W,
                                table.n_ops, table.max_trial, table.submit_op,
                                stream)
    if err != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {err}")
    term, pending = out.pop("_term"), out.pop("_pending")
    return state.replace(**out), out["last_reward"], term, pending


# The engine epilogue's outputs in the kernel's order: the carried state's
# 23 fields (the step kernel's input order, so the next step reads them as
# they lie) with the pool's new counter after the counts, then the shaped
# reward, term and trunc.  Without auto-reset only the last three exist.
_CARRY_KINDS = ((_GRID_IN, I8, None), (_DIM_IN, I8, (2,)),
                (_FLAG_IN, I8, ()),
                (_COUNT_IN + ("last_action_op", "_counter"), I32, ()),
                (("last_reward", "_reward"), F32, ()),
                (("_term", "_trunc"), torch.bool, ()))
_TAIL_KINDS = ((("_reward",), F32, ()), (("_term", "_trunc"), torch.bool, ()))
_EPI_OUTPUTS = 27
_ENV2_IN = _GRID_IN + _DIM_IN + _FLAG_IN + _COUNT_IN + ("last_action_op",
                                                      "last_reward")
# the post-step fields the step kernel did not write: checked every step
_CARRIED = (("input", I8, None), ("answer", I8, None),
            ("input_dim", I8, (2,)), ("answer_dim", I8, (2,)),
            ("reset_on_submit", I8, ()))


@functools.lru_cache(maxsize=64)
def _epilogue_layout(B: int, H: int, W: int, carry: bool):
    """The epilogue's arena: :func:`_layout` of its outputs, with the
    offsets padded to the kernel's 27 where only the tail is written."""
    if carry:
        return _layout(B, H, W, _CARRY_KINDS)
    total, offsets, kinds = _layout(B, H, W, _TAIL_KINDS)
    pad = [0] * (_EPI_OUTPUTS - len(offsets)) + list(offsets)
    return total, (ctypes.c_int64 * _EPI_OUTPUTS)(*pad), kinds


def step_epilogue(env, bs, env2: EnvState, reward: torch.Tensor,
                  term: torch.Tensor):
    """Everything ``BatchedEnv.step`` does after the transition: ``env``
    is the ``BatchedEnv``, ``bs`` the ``BatchedState`` stepped, ``env2``,
    ``reward`` and ``term`` what :func:`complete_step` returned for it.
    Returns ``(carry, obs, reward, terminated, truncated)`` as the step
    does.

    CPU tensors take ``env.plain_epilogue``.  CUDA tensors launch the
    engine epilogue once: the shaped reward, term, trunc, the carried
    state and the pool's counter are new tensors, and on a match
    ``env2.terminated``, a view of the step kernel's fresh arena, is
    updated in place.  With auto-reset on, the launch and a pool-less
    env's fresh draws sit in an ``auto_reset`` span.
    """
    dev = env2.grid.device
    if dev.type == "cpu":
        return env.plain_epilogue(bs, env2, reward, term)
    if dev.type != "cuda":
        raise ValueError(f"engine epilogue: unsupported device {dev}")
    return _checked_epilogue(env, bs, env2, reward, term)


def _checked_epilogue(env, bs, env2: EnvState, reward: torch.Tensor,
                      term: torch.Tensor):
    """:func:`step_epilogue` past its device dispatch: check what the step
    kernel did not write, find the fresh rows, launch."""
    dev = env2.grid.device
    B, H, W = env2.grid.shape
    for name, dtype, tail in _CARRIED:
        _check(name, getattr(env2, name), dtype,
               (B,) + ((H, W) if tail is None else tail), dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if not env.auto_reset:
            return _epilogue(load(), stream, env, bs, env2, reward, term,
                             None, 0)
        with TRACE.span("auto_reset"):
            pool, ros = bs.pool, env.reset_on_submit_i8
            if pool is None:
                fresh = env.draw_fresh(bs.generator, B) + (None, ros)
                rows, k = B, 0
            else:
                fresh = (pool.grid, pool.dim, pool.answer, pool.answer_dim,
                         pool.counter, ros)
                rows, k = pool.grid.shape[0], pool.k
                _check("pool.counter", pool.counter, I32, (B,), dev)
                if k < 1 or rows != B * k:
                    raise ValueError(f"engine epilogue: a pool of {rows} "
                                     f"rows for {B} envs")
            for name, t, shape in zip(
                    ("fresh grid", "fresh dim", "fresh answer",
                     "fresh answer_dim"), fresh,
                    ((rows, H, W), (rows, 2), (rows, H, W), (rows, 2))):
                _check(name, t, I8, shape, dev)
            # the fresh rows' reset_on_submit: a scalar or a [B] row
            _check("reset_on_submit", ros, I8, (B,) if ros.ndim else (), dev)
            return _epilogue(load(), stream, env, bs, env2, reward, term,
                             fresh, k)


def _epilogue(lib: ctypes.CDLL, stream, env, bs, env2: EnvState,
              reward: torch.Tensor, term: torch.Tensor, fresh, k: int):
    """Allocate the epilogue's outputs as views of one arena and launch
    the kernel of ``lib`` on ``stream``; the inputs are already checked.
    ``fresh`` is ``(grid, dim, answer, answer_dim, counter or None,
    reset_on_submit)`` with ``k`` pool rows per env (0: one drawn row per
    env), or None without auto-reset."""
    global EPILOGUE_LAUNCHES
    B, H, W = env2.grid.shape
    carry = fresh is not None
    total, offsets, kinds = _epilogue_layout(B, H, W, carry)
    ptrs = [getattr(env2, n).data_ptr() for n in _ENV2_IN]
    ptrs += [reward.data_ptr(), term.data_ptr()]
    if carry:
        ptrs += [0 if t is None else t.data_ptr() for t in fresh]
    else:
        ptrs += [0] * 6
    ros_stride = int(carry and fresh[5].ndim == 1)
    if (H, W) == (30, 30) and any(
            p & 3 for p in ptrs[:8] + ptrs[25:26] + ptrs[27:28]):
        raise ValueError("engine epilogue: a grid does not start on a "
                         "4-byte boundary")
    arena = torch.empty(total, dtype=torch.uint8, device=env2.grid.device)
    out = _views(arena, kinds)
    err = lib.arcle_epilogue_launch(
        (ctypes.c_void_p * len(ptrs))(*ptrs), arena.data_ptr(), offsets, B,
        H, W, k, int(env.dense_reward), int(env.pixel_reward),
        int(env.terminate_on_match), int(carry),
        max(int(env.episode_limit), 0), int(env.max_trial), ros_stride,
        stream)
    if err != 0:
        raise RuntimeError(f"engine epilogue launch failed: CUDA error {err}")
    EPILOGUE_LAUNCHES += 1
    reward2, term2, trunc = out.pop("_reward"), out.pop("_term"), \
        out.pop("_trunc")
    if not carry:
        nxt = type(bs)(env=env2, generator=bs.generator, pool=bs.pool)
        return nxt, env2, reward2, term2, trunc
    counter = out.pop("_counter")
    pool = None if bs.pool is None else type(bs.pool)(
        grid=bs.pool.grid, dim=bs.pool.dim, answer=bs.pool.answer,
        answer_dim=bs.pool.answer_dim, counter=counter)
    nxt = type(bs)(env=EnvState(**out), generator=bs.generator, pool=pool)
    return nxt, env2, reward2, term2, trunc


# last: importing ``utils`` imports the engine, which imports this module
from ..utils.metrics import TRACE  # noqa: E402
