"""Behaviour cloning for the Decision-Transformer policy.

Counterpart of ``arcle_tpu/training/dt_bc.py``.  The reference's DTPolicy
is "Under Construction" (DTPolicy.py:24) with no training loop; here
golden oracle traces (the validation harness's own data) become (grid,
action, return-to-go) sequences, and :class:`~arcle_tpu_torch.models.dt.
DTPolicy` trains with cross-entropy on the operation and squared error on
the normalised bbox.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dt import DTPolicy


class DTBatch(NamedTuple):
    grids: torch.Tensor      # i8 [B, T, 30, 30] pre-action grids
    rtg: torch.Tensor        # f32 [B, T] return-to-go
    actions: torch.Tensor    # i32 [B, T, 5] (x1, y1, x2, y2, op)
    timesteps: torch.Tensor  # i32 [B, T]
    mask: torch.Tensor       # f32 [B, T] 1 on real steps

    def to(self, device) -> "DTBatch":
        return DTBatch(*(x.to(device) for x in self))


def dataset_from_traces(tasks, traces, infos, T_max: int = 25,
                        device="cuda") -> DTBatch:
    """Replay golden UI traces through the oracle, recording the
    *pre-action* grid, the (bbox, op) action and the sparse rewards; pad
    to ``T_max`` steps.  Ops 20..27 with an unchanged selection are sent
    with an empty one, as the replay harness does."""
    from ..oracle import OracleEnv
    from ..validation import convert_ui_action

    G, R, A, TS, M = [], [], [], [], []
    for trace, (ti, sub) in zip(traces, infos):
        orc = OracleEnv("o2arc", max_trial=-1)
        orc.reset(tasks[ti][2][sub], tasks[ti][3][sub])
        grids, acts, rews = [], [], []
        for entry in trace[:T_max]:
            op, sel = convert_ui_action(entry)
            st = orc.state
            grids.append(st["grid"].copy())
            if sel.any():
                rows = np.nonzero(sel.any(1))[0]
                cols = np.nonzero(sel.any(0))[0]
                bbox = [rows[0], cols[0], rows[-1], cols[-1]]
            else:
                bbox = [0, 0, 0, 0]
            acts.append(bbox + [op])
            if 20 <= op <= 27 and np.array_equal(
                    st["selected"].astype(bool), sel):
                sel = np.zeros((30, 30), bool)
            _st, r, term = orc.step(sel.astype(np.int8), op)
            rews.append(float(r))
            if term:
                break
        n = len(grids)
        rtg = np.cumsum(rews[::-1])[::-1]
        pad = T_max - n
        G.append(np.pad(np.stack(grids), ((0, pad), (0, 0), (0, 0))))
        R.append(np.pad(rtg, (0, pad)))
        A.append(np.pad(np.asarray(acts, np.int32), ((0, pad), (0, 0))))
        TS.append(np.pad(np.arange(n, dtype=np.int32), (0, pad)))
        M.append(np.pad(np.ones(n, np.float32), (0, pad)))
    t = lambda xs, dt: torch.from_numpy(np.stack(xs).astype(dt)).to(device)
    return DTBatch(grids=t(G, np.int8), rtg=t(R, np.float32),
                   actions=t(A, np.int32), timesteps=t(TS, np.int32),
                   mask=t(M, np.float32))


def bc_loss(model: DTPolicy, batch: DTBatch) -> torch.Tensor:
    """Predict each step's action from the history: cross-entropy on the
    operation plus squared error on the normalised bbox, averaged over the
    real steps."""
    out = model(batch.grids, batch.rtg, batch.actions, batch.timesteps)
    n_ops = out["op_logits"].shape[-1]
    ls = F.log_softmax(out["op_logits"], dim=-1)
    classes = torch.arange(n_ops, device=ls.device)
    oh = (batch.actions[..., 4:5] == classes).to(ls.dtype)
    ce = -(ls * oh).sum(-1)
    tgt = batch.actions[..., :4].to(torch.float32) / model.cfg.grid_size
    mse = ((out["bbox"] - tgt) ** 2).sum(-1)
    denom = torch.clamp(batch.mask.sum(), min=1.0)
    return ((ce + mse) * batch.mask).sum() / denom


def train_bc(model: DTPolicy, batch: DTBatch,
             generator: Optional[torch.Generator] = None, n_steps: int = 50,
             lr: float = 3e-4, params: Optional[dict] = None,
             device="cuda") -> Tuple[DTPolicy, torch.Tensor]:
    """Full-batch Adam behaviour cloning on ``device``.

    The policy is a fresh ``DTPolicy(model.cfg)`` drawn from
    ``generator`` (a CPU generator), or loaded from the state dict
    ``params``.  Returns the trained policy and the losses ``[n_steps]``,
    where ``losses[i]`` is the loss before update ``i``."""
    policy = DTPolicy(model.cfg, generator)
    if params is not None:
        policy.load_state_dict(params)
    policy = policy.to(device)
    batch = batch.to(device)
    opt = torch.optim.Adam(policy.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses = torch.empty(n_steps, device=device)
    for i in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = bc_loss(policy, batch)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return policy, losses
