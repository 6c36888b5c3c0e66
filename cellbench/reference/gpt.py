"""The colour-equivariant GPT policy of the answer-given setting (ARCLE
paper §4.1.2) in plain PyTorch, float32, attention written out.

Tokens: the grid's cells, the answer's cells, one info token, one token per
colour op (the colour's embedding plus a shared colour-action token) and
CLS; the action-conditioned pass of the auxiliary losses appends the
chosen op's token and a Fourier encoding of the bbox.  Keys outside a
grid's dims are masked.  Pre-LayerNorm blocks (epsilon 1e-6), GELU's tanh
form, three-layer GELU heads.  The selection is a categorical over the
grid's bins per bbox coordinate, read from the chosen op's token.
Parameters are a name -> tensor mapping with the names of the port's
``GPTPolicy`` state dict.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .engine import EnvState
from .numerics import linear, matmul

I8 = torch.int8


def observe(st: EnvState) -> torch.Tensor:
    """int8 ``[B, 2*h*w + 4]``: grid, grid_dim, answer, answer_dim."""
    B = st.grid.shape[0]
    return torch.cat([st.grid.reshape(B, -1).to(I8), st.grid_dim.to(I8),
                      st.answer.reshape(B, -1).to(I8),
                      st.answer_dim.to(I8)], dim=-1)


def potential(obs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """phi(s) = -(wrong cells inside the answer's dims) / (its area)."""
    P = h * w
    g, a = obs[..., :P], obs[..., P + 2:2 * P + 2]
    ad = obs[..., 2 * P + 2:2 * P + 4].to(torch.int64)
    idx = torch.arange(P, device=obs.device)
    inside = (idx // w < ad[..., :1]) & (idx % w < ad[..., 1:2])
    wrong = (inside & (g != a)).sum(-1).to(torch.float32)
    area = torch.clamp(ad[..., 0] * ad[..., 1], min=1).to(torch.float32)
    return -wrong / area


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class GPTRef:
    def __init__(self, policy: dict):
        self.h, self.w = policy["grid"]
        self.C = policy["n_embd"]
        self.nh = policy["n_head"]
        self.n_layer = policy["n_layer"]
        self.nc = policy["num_colors"]
        self.na = policy["num_actions"]
        self.bins = policy["bbox_bins"]
        self.eps = policy["layernorm_eps"]
        if policy["arch"] != "color_eq" or self.na != self.nc:
            raise ValueError("the reference covers the colour-equivariant "
                             "policy over colour ops alone")

    # ---- layers ----------------------------------------------------------
    def _dense(self, p, name, x, prec):
        return linear(x, p[f"{name}.weight"], p[f"{name}.bias"], prec)

    def _ln(self, p, name, x):
        return F.layer_norm(x, (self.C,), p[f"{name}.weight"],
                            p[f"{name}.bias"], self.eps)

    def _head(self, p, name, x, prec):
        x = _gelu(self._dense(p, f"{name}.Dense_0", x, prec))
        x = _gelu(self._dense(p, f"{name}.Dense_1", x, prec))
        return self._dense(p, f"{name}.Dense_2", x, prec)

    def _attn(self, p, name, x, attend, prec):
        B, T, C = x.shape
        hd = C // self.nh
        q, k, v = self._dense(p, f"{name}.qkv", x, prec).split(C, dim=-1)
        heads = lambda a: a.view(B, T, self.nh, hd).transpose(1, 2)
        s = matmul(heads(q), heads(k).transpose(-1, -2), prec) \
            / math.sqrt(hd)
        s = s.masked_fill(~attend, float("-inf"))
        y = matmul(torch.softmax(s, dim=-1), heads(v), prec)
        return self._dense(p, f"{name}.proj",
                           y.transpose(1, 2).reshape(B, T, C), prec)

    def _mask(self, dim):
        d = dim.to(torch.int64)
        r = torch.arange(self.h, device=dim.device).view(1, self.h, 1)
        c = torch.arange(self.w, device=dim.device).view(1, 1, self.w)
        return ((r < d[:, 0, None, None]) & (c < d[:, 1, None, None])
                ).reshape(dim.shape[0], self.h * self.w)

    # ---- the network -----------------------------------------------------
    def forward(self, p: Dict[str, torch.Tensor], obs: torch.Tensor,
                prec: str, acts: Optional[torch.Tensor] = None):
        h, w, C, nc = self.h, self.w, self.C, self.nc
        P = h * w
        B = obs.shape[0]
        grid = obs[:, :P].long()
        gdim = obs[:, P:P + 2]
        ans = obs[:, P + 2:2 * P + 2].long()
        adim = obs[:, 2 * P + 2:2 * P + 4]
        E = p["color_encoder.weight"]
        color = lambda g: E[g.clamp(0, nc - 1)]
        pe = p["pos_emb"]
        grid_t = color(grid) + pe + p["state_emb"][0]
        inp_t = color(ans) + pe + p["state_emb"][6]
        info = (p["trials_encoder.weight"][0]
                + p["active_encoder.weight"][0]).expand(B, 1, C)
        op_tokens = (p["color_action_tkn"] + E[None]).expand(B, -1, -1)
        tokens = [grid_t, inp_t, info, op_tokens,
                  p["cls_tkn"].expand(B, 1, C)]
        if acts is not None:
            op = acts[:, 4].long()
            enc_op = (p["color_action_tkn"][0] + color(op))[:, None]
            box = acts[:, :4].to(torch.float32) / max(h, w)
            ang = 2 * math.pi * p["bbox_encoder.coefficients"] \
                * box[..., None]
            feat = torch.cat([torch.cos(ang), torch.sin(ang)], -1)
            enc_bb = _gelu(self._dense(p, "bbox_encoder.encoder",
                                       feat.reshape(B, feat.shape[1] * feat.shape[2]),
                                       prec))[:, None]
            tokens += [enc_op, enc_bb]
        x = torch.cat(tokens, dim=1)
        n_fixed = x.shape[1] - 2 * P
        attend = torch.cat([self._mask(gdim), self._mask(adim),
                            torch.ones((B, n_fixed), dtype=torch.bool,
                                       device=x.device)], 1)[:, None, None]
        for i in range(self.n_layer):
            b = f"block_{i}"
            x = x + self._attn(p, f"{b}.SelfAttention_0",
                               self._ln(p, f"{b}.LayerNorm_0", x), attend,
                               prec)
            y = self._ln(p, f"{b}.LayerNorm_1", x)
            y = self._dense(p, f"{b}.Dense_1",
                            _gelu(self._dense(p, f"{b}.Dense_0", y, prec)),
                            prec)
            x = x + y
        x = self._ln(p, "ln_f", x)
        ops_at = 2 * P + 1
        cls_at = ops_at + self.na
        op_x, cls_x = x[:, ops_at:cls_at], x[:, cls_at]
        out = {"op_logits": self._head(p, "head_operation", op_x,
                                       prec)[..., 0],
               "bbox_logits": self._head(p, "head_bbox_logits", op_x,
                                         prec).reshape(B, self.na, 4,
                                                       self.bins),
               "value": self._head(p, "head_critic", cls_x, prec)[:, 0]}
        if acts is not None:
            out["rtm1"] = self._head(p, "head_aux_rtm1", cls_x, prec)[:, 0]
            out["r"] = self._head(p, "head_aux_reward", x[:, -1],
                                  prec)[:, 0]
            out["g_logits"] = self._head(p, "head_aux_transition",
                                         x[:, :P], prec)
        return out

    # ---- the agent -------------------------------------------------------
    def dists(self, p, obs, acts, prec):
        """Log-softmax of the op head and of the chosen op's four bbox
        heads, and the value."""
        out = self.forward(p, obs, prec)
        op = acts[:, 4].long()
        lop = F.log_softmax(out["op_logits"], -1)
        bl = out["bbox_logits"][torch.arange(obs.shape[0],
                                             device=obs.device), op]
        return lop, F.log_softmax(bl, -1), out["value"]

    def evaluate(self, p, obs, acts, prec):
        lop, lbb, value = self.dists(p, obs, acts, prec)
        lp = lop.gather(-1, acts[:, 4:5].long())[:, 0] + \
            lbb.gather(-1, acts[:, :4].long()[..., None])[..., 0].sum(-1)
        ent = -(lop.exp() * lop).sum(-1) - (lbb.exp() * lbb).sum((-2, -1))
        return lp, value, ent

    def value(self, p, obs, prec):
        return self.forward(p, obs, prec)["value"]

    def aux(self, p, obs, acts, prec):
        out = self.forward(p, obs, prec, acts)
        return {"rtm1": out["rtm1"], "r": out["r"],
                "g_logits": out["g_logits"]}
