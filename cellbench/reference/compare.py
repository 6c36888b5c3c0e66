"""The numbers that decide ``correct``: what the port produced against
what the reference works out from the same inputs.

* ``transitions``: rows that differ (exact): observations, rewards, flags,
  the final state, and start or reset rows that are no fresh episode of
  the task bank.
* ``logp_gap``: the widest gap between the port's log-probability of an
  action taken and the reference's.  ``value_gap``: the same for the
  values (and the TimeLimit bootstrap values).
* ``loss_gap``: the widest gap between an iteration's loss (the mean of
  its updates' losses) and the reference's.  Absolute: the loss is a sum
  of terms of either sign and can lie near 0.
* ``logp_gap_first``, ``value_gap_first``, ``loss_gap_first``: the same
  over the first iteration alone, where both sides start from the same
  weights.
* ``loss_gap_update1``: the gap between the first update's loss and the
  reference's: the same weights and the same learner batch on both sides,
  before any update has carried them apart.
* ``grad_gap``: the first optimizer step's gradient, by the worst leaf:
  the gap between the two norms over the larger of the reference's norm
  of that leaf and of the median leaf.
* ``grad_diff``, ``grad_diff_median``: the first optimizer step's
  gradient by the norm of its difference from the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf: the
  worst leaf and the median leaf.  Both sides start from the same weights
  and the same rows, so no update has carried them apart yet; a gradient
  taken over other rows points elsewhere even where the global-norm clip
  leaves its norm as it was.
* ``update_gap``: the parameters' change over the checked updates, by the
  worst leaf, the same way, over the entries whose first gradient in the
  reference is at least a thousandth of the median leaf's root mean
  square: an entry whose gradient is zero up to rounding (a key's bias
  under softmax, an embedding row no input selects) moves under Adam by
  round-off alone.  ``update_gap_median``: the median leaf's.
* ``argmax_gap``: for greedy actions, how far below the reference's best
  log-probability the action taken lies, by the widest head.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .engine import FIELDS


def _rows_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    d = a != b
    return int(d.reshape(d.shape[0], -1).any(1).sum()) if d.ndim > 1 \
        else int(d.sum())


def state_rows_differ(a, b) -> int:
    """Envs whose state differs in any field."""
    B = a.grid.shape[0]
    bad = torch.zeros(B, dtype=torch.bool, device=a.grid.device)
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        bad |= (x != y).reshape(B, -1).any(1)
    return int(bad.sum())


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(cand: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Per leaf: the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep is None or keep[k]]
    rn = {k: _norm(ref[k]) for k in names}
    med = sorted(rn.values())[len(rn) // 2] if rn else 0.0
    out = {}
    for k in names:
        denom = max(rn[k], med)
        if denom > 0:
            c = _norm(cand[k]) if k in cand else 0.0
            out[k] = abs(c - rn[k]) / denom
    return out


def diff_ratios(cand: Dict[str, torch.Tensor],
                ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf: the norm of the difference over the larger of the
    reference's norm of that leaf and of the median leaf (a leaf the
    candidate lacks is zero there)."""
    rn = {k: _norm(v) for k, v in ref.items()}
    med = sorted(rn.values())[len(rn) // 2] if rn else 0.0
    return {k: _norm(cand[k] - v if k in cand else v) / max(rn[k], med)
            for k, v in ref.items() if max(rn[k], med) > 0}


def grad_numbers(cand: Dict[str, torch.Tensor],
                 ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    d = sorted(diff_ratios(cand, ref).values())
    return {"grad_gap": leaf_gap(cand, ref),
            "grad_diff": d[-1] if d else 0.0,
            "grad_diff_median": d[len(d) // 2] if d else 0.0}


def leaf_gap(cand, ref, keep=None) -> float:
    return max(leaf_gaps(cand, ref, keep).values(), default=0.0)


def _update_loss_gaps(c: dict, r: dict) -> list:
    """Each update's loss gap; not a number where the two sides made a
    different count of updates."""
    if len(c["update_losses"]) != len(r["update_losses"]):
        return [math.nan]
    return [abs(float(a) - float(b))
            for a, b in zip(c["update_losses"], r["update_losses"])]


def ppo(cand: dict, ref: dict, weights0: Dict[str, torch.Tensor],
        detail: bool = False) -> Dict[str, float]:
    """The numbers compared; ``detail`` adds, for the look behind a
    reading, each iteration's log-prob and loss gaps, the first
    iteration's first eight update losses' gaps, the worst leaves of the
    update gap, the median leaf's, and the update gap after the first
    iteration.  ``cand`` without ``first_grads`` (a window iteration,
    whose Adam state holds no gradient alone) reads no ``grad_gap``."""
    trans = int(ref.get("resets_bad", 0))
    lp_gap = v_gap = loss_gap = 0.0
    per_iter = []
    first = {}
    for i, (c, r) in enumerate(zip(cand["iters"], ref["iters"])):
        key = "obs_digest" if "obs_digest" in r else "obs"
        trans += _rows_differ(c[key].flatten(0, 1), r[key].flatten(0, 1))
        for k in ("rewards", "dones", "terminated"):
            trans += _rows_differ(c[k].flatten(), r[k].flatten())
        need = r["need"]
        trans += int(((c["final_values"] != 0) & ~need).sum())
        lg_i = _max((c["log_probs"] - r["log_probs"]).abs())
        vg_i = max(_max((c["values"] - r["values"]).abs()),
                   _max((c["final_values"] - r["final_values"])[need].abs()))
        lg = abs(float(c["loss"]) - float(r["loss"]))
        if i == 0:
            first = {"logp_gap_first": lg_i, "value_gap_first": vg_i,
                     "loss_gap_first": lg,
                     "loss_gap_update1": _update_loss_gaps(c, r)[0]}
        lp_gap, v_gap = max(lp_gap, lg_i), max(v_gap, vg_i)
        loss_gap = max(loss_gap, lg)
        per_iter.append({"logp_gap": _max((c["log_probs"]
                                           - r["log_probs"]).abs()),
                         "loss_gap": lg, "loss": float(r["loss"])})
    trans += state_rows_differ(cand["final"], ref["final"])
    g_ref = ref["first_grads"]
    rms = sorted(_norm(v) / max(v.numel(), 1) ** 0.5 for v in g_ref.values())
    floor = 1e-3 * rms[len(rms) // 2]
    mask = {k: v.abs() >= floor for k, v in g_ref.items()}
    keep = {k: bool(m.any()) for k, m in mask.items()}
    change = lambda params: {k: (params[k] - weights0[k]) * mask[k]
                             for k in weights0}
    ups = leaf_gaps(change(cand["params_after"]), change(ref["params_after"]),
                    keep)
    ranked = sorted(ups.items(), key=lambda kv: -kv[1])
    out = {"transitions": float(trans), "logp_gap": lp_gap,
           "value_gap": v_gap, "loss_gap": loss_gap,
           "update_gap": ranked[0][1] if ranked else 0.0,
           "update_gap_median": ranked[len(ranked) // 2][1] if ranked
           else 0.0}
    if "first_grads" in cand:
        out.update(grad_numbers(cand["first_grads"], g_ref))
    out.update(first)
    if detail:
        out["detail"] = {
            "iterations": per_iter,
            "update_loss_gaps_first": _update_loss_gaps(
                cand["iters"][0], ref["iters"][0])[:8],
            "update_gap_worst": ranked[:6],
            "update_gap_first_iteration": leaf_gap(
                change(cand["params_after_1"]), change(ref["params_after_1"]),
                keep) if "params_after_1" in cand else None,
            "grad_gap_worst": sorted(leaf_gaps(
                cand["first_grads"], g_ref).items(),
                key=lambda kv: -kv[1])[:3] if "first_grads" in cand
            else None}
    return out
