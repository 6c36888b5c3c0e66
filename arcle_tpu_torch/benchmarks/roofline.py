"""Roofline accounting: bytes and FLOPs per env-step next to steps/s.

Counterpart of ``arcle_tpu/benchmarks/roofline.py``.  It answers "is N
env-steps/s good on this card?" by setting the measured rate against the
card's published peaks.

* :data:`PEAKS` -- dense rates from NVIDIA's data sheet, keyed by the
  CUDA device name.  A card not listed gets no peaks, and
  :func:`summarize` then states no share: a guessed peak would give a
  guessed share.
* :func:`cost_from_flop_counter` -- the FLOPs of a call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions, attention).  PyTorch has no byte cost model, so unlike
  JAX's ``cost_from_compiled`` it gives no bytes.
* :func:`step_kernel_bytes` -- the bytes one step of the CUDA step kernel
  must move for these inputs; :func:`step_kernel_bytes_max` -- the most
  it moves per env-step, from its argument list.

JAX's ``pick_engine`` is not ported: it picks the plain path where that
measured faster, which on the card would hide the kernel.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict, Optional

import torch

# NVIDIA's data sheet, the SXM part, dense rates at the 700 W limit:
# TFLOP/s by type (fp32 outside the tensor cores) and HBM GB/s
H100_SXM = {"bf16_tflops": 989.0, "tf32_tflops": 495.0,
            "fp32_tflops": 67.0, "hbm_gbps": 3350.0}
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": H100_SXM,
    "H100 SXM": H100_SXM,
    "cpu": {"bf16_tflops": 1.0, "hbm_gbps": 50.0},  # nominal host
}

# per env: the dims, flags and counters the kernel reads (6 x 2 + 5 + 2 x
# 4 + the int32 op) and writes (4 x 2 + 4 + 3 x 4 + the float32 reward +
# term and pending)
SCALAR_BYTES = 29 + 30


def card_line(index: int = 0) -> str:
    """``nvidia-smi``'s ``name, power.limit`` line for card ``index``, as
    "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_peaks(device) -> Dict:
    """The peaks of ``device`` with its ``name`` and ``power_limit_w`` (in
    W, from ``nvidia-smi``; None on the CPU); an unknown card gets the
    name and the limit alone."""
    dev = torch.device(device)
    if dev.type == "cpu":
        out = {"name": "cpu", "power_limit_w": None}
    else:
        name, power = card_line(dev.index or 0).rsplit(",", 1)
        out = {"name": name.strip(),
               "power_limit_w": float(power.split()[0])}
    for key, peaks in PEAKS.items():
        if key in out["name"]:
            return dict(peaks, **out)
    return out


def cost_from_flop_counter(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops": n}`` for one call ``fn(*args)``, forward and backward,
    as ``FlopCounterMode`` counts them (a multiply-add is 2)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}


def step_kernel_bytes(st, act, table) -> int:
    """The bytes one kernel step of these inputs must move: each grid the
    op reads (the copied-through fields included) once, the 6 output grids
    once, and the per-env scalars.  Grids an op overwrites whole, or that
    it does not consult for this env's selection and flags, are not
    counted: the grid under ResizeGrid with a selection and under a
    re-initialising Submit, the input except where Copy, CopyFromInput or
    a re-initialising Submit takes it."""
    from ..ops.groups import G, precompute_selection
    from ..ops.table import lookup
    n, H, W = st.grid.shape
    _, grp, par, rs = lookup(act, table)
    pre = precompute_selection(act.selection)
    isin = lambda *gs: torch.isin(grp, torch.tensor(gs, device=grp.device))
    active0 = (st.active != 0) & ~rs
    obj_ok = (grp == G.OBJECT) & (pre.any | active0)
    stored = obj_ok & ~pre.any              # a stored object moves on
    from_input = par == 0
    dim = torch.where(from_input.view(-1, 1), st.input_dim,
                      st.grid_dim).to(torch.int32)
    copy_ok = (grp == G.COPY) & pre.any & \
        ~((pre.rmax > dim[:, 0]) | (pre.cmax > dim[:, 1]))
    sub_ros = (grp == G.SUBMIT) & (st.trials_remain != 0) & \
        (st.reset_on_submit != 0)
    keep = ~obj_ok & ~sub_ros
    i64 = lambda m: m.to(torch.int64)
    grids = (i64(~isin(G.COPY_FROM_INPUT, G.RESET_GRID) & ~sub_ros
                 & ~((grp == G.RESIZE_GRID) & pre.any))           # grid
             + i64(isin(G.COLOR, G.FLOOD, G.OBJECT, G.COPY, G.PASTE,
                        G.RESIZE_GRID, G.CROP_GRID))              # selection
             + i64(keep & ~rs)                                    # selected
             + 3 * i64(keep | stored)       # object, object_sel, background
             + i64(~copy_ok & ~sub_ros)                           # clip
             + i64((copy_ok & from_input) | (grp == G.COPY_FROM_INPUT)
                   | sub_ros)                                     # input
             + i64(grp == G.SUBMIT))                              # answer
    return int(grids.sum()) * H * W + n * (6 * H * W + SCALAR_BYTES)


def step_kernel_bytes_max(table, H: int, W: int) -> float:
    """The most bytes one env-step of the kernel moves on ``H x W`` grids:
    every operand of its argument list read once (8 state grids and the
    selection, the answer only where ``table`` has a Submit op) and every
    result written once (6 grids), with the per-env scalars.  There is no
    permutation-matrix term: the Pallas kernel's object ops stream two
    900x900 matrices, the CUDA kernel has none.  The op table's rows are
    read once per launch, not per env, and are left out."""
    from ..ops.groups import G
    grids_in = 9 if G.SUBMIT in table.group else 8
    return float((grids_in + 6) * H * W + SCALAR_BYTES)


def summarize(rate_steps_per_s: float, batch: int, steps: int,
              cost: Optional[Dict[str, float]],
              analytic_bytes_per_step: Optional[float] = None,
              peaks: Optional[Dict] = None,
              mfu_peak: str = "bf16") -> Dict:
    """Utilization block for a measured rate (JAX's keys and rounding).

    ``cost`` is the FLOP count of ``steps`` env-steps at ``batch`` envs
    (:func:`cost_from_flop_counter`); rates are per env-step.  ``mfu_pct``
    is taken against the ``mfu_peak`` rate (``"bf16"``, ``"tf32"`` or
    ``"fp32"``), named in the result; a share whose peak ``peaks`` lacks
    is left out."""
    peaks = peaks or {}
    out = {"device_kind": peaks.get("name"),
           "power_limit_w": peaks.get("power_limit_w")}
    n_env_steps = batch * steps
    flop_peak = peaks.get(f"{mfu_peak}_tflops")
    if cost and cost["flops"] > 0:
        flops_per_step = cost["flops"] / n_env_steps
        out["flops_per_env_step"] = round(flops_per_step, 1)
        if flop_peak:
            out["mfu_pct"] = round(
                100.0 * flops_per_step * rate_steps_per_s
                / (flop_peak * 1e12), 3)
            out["mfu_peak"] = mfu_peak
    if analytic_bytes_per_step is not None:
        out["analytic_bytes_per_env_step"] = round(
            analytic_bytes_per_step, 1)
        if "hbm_gbps" in peaks:
            out["analytic_hbm_util_pct"] = round(
                100.0 * analytic_bytes_per_step * rate_steps_per_s
                / (peaks["hbm_gbps"] * 1e9), 2)
    return out
