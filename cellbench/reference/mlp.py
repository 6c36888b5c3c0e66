"""The FCPolicy in plain PyTorch: a tanh MLP over the flattened
FilterO2ARC observation, five categorical heads (x1, y1, x2, y2, op) and a
value head.  Parameters are a name -> tensor mapping with the names of the
port's ``FCPolicy`` state dict (``fc_<i>.weight``, ``pi.bias``, ...)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from .engine import EnvState
from .numerics import linear

FILTER_KEYS = ("trials_remain", "grid", "grid_dim", "clip", "clip_dim",
               "active", "object", "object_dim", "object_pos")


def observe(st: EnvState) -> torch.Tensor:
    """FilterO2ARC + FlattenObservation: the nine keys in sorted order,
    each flattened, as int8 ``[B, 2710]`` at 30x30."""
    B = st.grid.shape[0]
    return torch.cat([getattr(st, k).reshape(B, -1).to(torch.int8)
                      for k in sorted(FILTER_KEYS)], dim=1)


class MLPRef:
    def __init__(self, policy: dict):
        self.hidden = tuple(policy["hidden"])
        self.sizes = tuple(policy["heads"])

    def forward(self, p: Dict[str, torch.Tensor], obs: torch.Tensor,
                precision: str) -> Tuple[Tuple[torch.Tensor, ...],
                                         torch.Tensor]:
        x = obs.to(torch.float32)
        for i in range(len(self.hidden)):
            x = torch.tanh(linear(x, p[f"fc_{i}.weight"], p[f"fc_{i}.bias"],
                                  precision))
        logits = linear(x, p["pi.weight"], p["pi.bias"], precision)
        value = linear(x, p["vf.weight"], p["vf.bias"], precision)[:, 0]
        return tuple(torch.split(logits, self.sizes, dim=-1)), value

    def evaluate(self, p, obs, acts, precision):
        """``(log_prob, value, entropy)`` of actions ``[B, 5]``."""
        heads, value = self.forward(p, obs, precision)
        lp = sum(F.log_softmax(h, -1).gather(
            -1, acts[:, k].long()[:, None])[:, 0]
            for k, h in enumerate(heads))
        ent = sum(-(F.softmax(h, -1) * F.log_softmax(h, -1)).sum(-1)
                  for h in heads)
        return lp, value, ent

    def value(self, p, obs, precision):
        return self.forward(p, obs, precision)[1]
