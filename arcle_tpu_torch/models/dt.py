"""Decision-Transformer-style policy.

Counterpart of ``arcle_tpu/models/dt.py`` (the reference's DTPolicy, a
minGPT-derived model marked "Under Construction" at DTPolicy.py:24): a
compact causal transformer over three tokens per timestep, [return-to-go,
grid, op + bbox], each with the timestep's embedding added.  Predictions
are read from each step's grid token.

Module and parameter names follow the flax tree (``block_0.
MultiHeadDotProductAttention_0.query``, ``head_op``), so
:func:`models.convert.dt_state_dict_from_flax` is a renaming plus the
reshape of flax's ``DenseGeneral`` kernels (``[C, H, D]`` and ``[H, D,
C]``) into ``nn.Linear`` weights.  Layers, epsilon, GELU and initialisers
are flax's, as in :mod:`.gpt`.  Causal attention is one
``F.scaled_dot_product_attention`` with a bool mask; the JAX package leaves
attention to XLA, so there is no kernel of its own to port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .gpt import Dense, Embed, LayerNorm, _gelu


@dataclasses.dataclass(frozen=True)
class DTConfig:
    n_layer: int = 4
    n_head: int = 8
    n_embd: int = 128
    max_timesteps: int = 100
    grid_size: int = 30
    num_colors: int = 10
    num_actions: int = 35
    dtype: torch.dtype = torch.float32


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` for self-attention:
    query / key / value projections to ``n_head`` heads of ``C // n_head``,
    scaled dot-product attention, and the output projection."""

    def __init__(self, cfg: DTConfig):
        super().__init__()
        C, dt = cfg.n_embd, cfg.dtype
        self.n_head = cfg.n_head
        self.query = Dense(C, C, dt)
        self.key = Dense(C, C, dt)
        self.value = Dense(C, C, dt)
        self.out = Dense(C, C, dt)

    def forward(self, x: torch.Tensor, attend: torch.Tensor) -> torch.Tensor:
        """``attend``: bool ``[L, L]``, True where a query may attend a
        key."""
        B, L, C = x.shape
        heads = lambda a: a.view(B, L, self.n_head, -1).transpose(1, 2)
        y = F.scaled_dot_product_attention(
            heads(self.query(x)), heads(self.key(x)), heads(self.value(x)),
            attn_mask=attend)
        return self.out(y.transpose(1, 2).reshape(B, L, C))


class CausalBlock(nn.Module):
    def __init__(self, cfg: DTConfig):
        super().__init__()
        C, dt = cfg.n_embd, cfg.dtype
        self.LayerNorm_0 = LayerNorm(C, dt)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            cfg)
        self.LayerNorm_1 = LayerNorm(C, dt)
        self.Dense_0 = Dense(C, 4 * C, dt)
        self.Dense_1 = Dense(4 * C, C, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[1]
        attend = torch.ones((L, L), dtype=torch.bool,
                            device=x.device).tril()
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x),
                                                    attend)
        return x + self.Dense_1(_gelu(self.Dense_0(self.LayerNorm_1(x))))


class DTPolicy(nn.Module):
    """Tokens per timestep: [rtg, grid, op + (x1, y1, x2, y2)]; predicts
    each step's action from its grid token.  ``generator`` (a CPU
    ``torch.Generator``) makes the initial draw reproducible on any
    device."""

    def __init__(self, cfg: DTConfig = DTConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        C, dt = c.n_embd, c.dtype
        self.grid_proj = Dense(c.grid_size * c.grid_size * c.num_colors, C,
                               dt)
        self.rtg_proj = Dense(1, C, dt)
        self.op_emb = Embed(c.num_actions, C, dt)
        self.coord_proj = Dense(4, C, dt)
        self.time_emb = Embed(c.max_timesteps, C, dt)
        for i in range(c.n_layer):
            setattr(self, f"block_{i}", CausalBlock(c))
        self.ln_f = LayerNorm(C, dt)
        self.head_op = Dense(C, c.num_actions, dt)
        self.head_bbox = Dense(C, 4, dt)
        self.head_value = Dense(C, 1, dt)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, grids: torch.Tensor, rtg: torch.Tensor,
                actions: torch.Tensor, timesteps: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """grids int ``[B, T, 30, 30]``; rtg float ``[B, T]``; actions int
        ``[B, T, 5]`` (x1, y1, x2, y2, op); timesteps int ``[B, T]``."""
        c = self.cfg
        B, T = rtg.shape
        cells = torch.clamp(grids.long(), 0, c.num_colors - 1)
        grid_tok = self.grid_proj(
            F.one_hot(cells, c.num_colors).reshape(B, T, -1)
            .to(torch.float32))
        rtg_tok = self.rtg_proj(rtg[..., None].to(torch.float32))
        op_tok = self.op_emb(torch.clamp(actions[..., 4].long(), 0,
                                         c.num_actions - 1))
        coord_tok = self.coord_proj(actions[..., :4].to(torch.float32)
                                    / c.grid_size)
        time_emb = self.time_emb(torch.clamp(timesteps.long(), 0,
                                             c.max_timesteps - 1))

        toks = torch.stack([rtg_tok, grid_tok, op_tok + coord_tok], dim=2)
        x = (toks + time_emb[:, :, None]).reshape(B, 3 * T, c.n_embd)
        for i in range(c.n_layer):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_f(x)

        h = x.reshape(B, T, 3, c.n_embd)[:, :, 1]
        return {"op_logits": self.head_op(h),
                "bbox": torch.sigmoid(self.head_bbox(h)),
                "value": self.head_value(h).squeeze(-1)}
