"""The GPT policy network.

Counterpart of ``arcle_tpu/models/gpt.py`` (the reference's
GPTPolicy.py): tokens = H*W grid cells + H*W input cells + 1 info token +
n_ops operation tokens + 1 CLS (+ two query tokens when ``factorized``,
+ the chosen action's two tokens in the action-conditioned pass),
self-attention with a key-padding mask over the inactive grid area, and
heads for the operation logits (per op token), the bbox mean / std, the
critic and the auxiliary r_{t-1} / r_t / next-grid predictions.

Module and parameter names follow the flax tree (``block_3.
SelfAttention_0.qkv``, ``head_bbox_mean.Dense_2``, ``bbox_encoder.
encoder``), so :func:`models.convert.gpt_state_dict_from_flax` is a
renaming.  Parameters are float32; each layer casts its inputs and
weights to ``cfg.dtype`` (bf16 by default) as flax's ``dtype=`` does,
LayerNorm normalises in float32, and each head's last layer computes in
float32.  Where flax and PyTorch differ the port follows flax: LayerNorm
epsilon 1e-6, GELU's tanh approximation, lecun-normal (truncated) Dense
kernels, embeddings drawn N(0, 1/features), orthogonal heads.

Attention is one function, ``F.scaled_dot_product_attention`` with the
key-padding mask; the JAX package's dense einsum path (T < 1024) and its
online-softmax ``lax.scan`` (T >= 1024) compute the same softmax.  On
CUDA the memory-efficient backend is pinned: it stores no T x T scores
(the math backend would hold [B, 16, 1837, 1837] floats per layer), and
a call it cannot take raises instead of falling back.  ``attn_chunk`` and
``dense_attn_budget`` only chose between the JAX package's two paths;
they are kept in :class:`GPTConfig` so configurations carry over, and
the port reads neither.

Dropout modules keep the configured rates; every RL call runs them
deterministic (``deterministic=True``, the default), as the JAX agents do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from .mlp import _TRUNC_STD


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Mirror of gptconfig.yaml / train_gpt.py:65-80."""

    grid_x: int = 30
    grid_y: int = 30
    num_colors: int = 10
    num_actions: int = 35
    n_layer: int = 8
    n_head: int = 16
    n_embd: int = 128
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True          # recompute each block in the backward
    color_equivariant: bool = False  # color-op tokens are pure functions
                                # of the color embedding (paper §4.1.2)
    factorized: bool = False    # op and selection from two independent
                                # query tokens (paper §4.1.2)
    bbox_bins: int = 0          # >0: also emit categorical bbox logits
                                # [n_ops, 4, bins]
    attn_chunk: int = 512       # JAX streaming-attention chunk; unread
    dense_attn_budget: int = 0  # JAX dense-vs-streaming switch; unread

    @property
    def num_pixel(self) -> int:
        return self.grid_x * self.grid_y

    @property
    def num_tokens(self) -> int:
        # grid + input + info + op tokens + cls (GPTPolicy.py:380-381)
        return 2 * self.num_pixel + 1 + self.num_actions + 1


def active_mask(dim: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bool ``[..., H*W]``: the cells inside ``dim`` (``[..., 2]``, rows and
    columns from the origin; GPTPolicy.py:291-304)."""
    d = dim.to(torch.int32)
    rows = torch.arange(H, device=dim.device).view(H, 1)
    cols = torch.arange(W, device=dim.device).view(1, W)
    inside = (rows < d[..., 0, None, None]) & (cols < d[..., 1, None, None])
    return inside.reshape(*dim.shape[:-1], H * W)


def _dropout(x: torch.Tensor, drop: nn.Dropout,
             deterministic: bool) -> torch.Tensor:
    return x if deterministic else F.dropout(x, drop.p, training=True)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")        # flax nn.gelu's default


class Dense(nn.Linear):
    """flax ``nn.Dense``: inputs, kernel and bias cast to ``dtype``;
    kernels lecun-normal (truncated) unless ``ortho_gain`` asks for an
    orthogonal one; zero biases."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 ortho_gain: Optional[float] = None):
        # set first: nn.Linear.__init__ calls reset_parameters
        self.dtype, self.ortho_gain = dtype, ortho_gain
        super().__init__(d_in, d_out)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        if self.ortho_gain is not None:
            nn.init.orthogonal_(self.weight, gain=self.ortho_gain,
                                generator=generator)
        else:
            std = math.sqrt(1.0 / self.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: epsilon 1e-6, statistics and affine in
    float32, the result cast to ``dtype``."""

    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__(width, eps=1e-6)
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        super().reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.to(torch.float32), self.normalized_shape,
                            self.weight, self.bias, self.eps).to(self.dtype)


class Embed(nn.Embedding):
    """flax ``nn.Embed``: the table drawn N(0, 1/features) (variance
    scaling 1.0, fan-in, normal) and cast to ``dtype``."""

    def __init__(self, n: int, width: int, dtype: torch.dtype):
        self.dtype = dtype
        super().__init__(n, width)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(self.embedding_dim),
                        generator=generator)

    def table(self) -> torch.Tensor:
        return self.weight.to(self.dtype)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.table())


def _param(*shape: int) -> nn.Parameter:
    """Uninitialised: ``reset_parameters`` draws it."""
    return nn.Parameter(torch.empty(shape))


class SelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        C = cfg.n_embd
        self.cfg = cfg
        self.qkv = Dense(C, 3 * C, cfg.dtype)
        self.proj = Dense(C, C, cfg.dtype)
        self.attn_drop = nn.Dropout(cfg.attn_pdrop)
        self.resid_drop = nn.Dropout(cfg.resid_pdrop)

    def forward(self, x: torch.Tensor, attend: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        """``attend``: bool ``[B, 1, 1, T]``, True where a key may be
        attended (the JAX ``pad_mask`` negated)."""
        B, T, C = x.shape
        nh = self.cfg.n_head
        q, k, v = self.qkv(x).split(C, dim=-1)     # jnp.split(qkv, 3, -1)
        heads = lambda a: a.view(B, T, nh, C // nh).transpose(1, 2)
        # The info, op and CLS keys are never masked, so no row is fully
        # masked: a masked score of -inf (SDPA) and -1e30 (the JAX
        # streaming path) give the same softmax.
        pin = sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION) if x.is_cuda \
            else contextlib.nullcontext()
        with pin:
            y = F.scaled_dot_product_attention(
                heads(q), heads(k), heads(v), attn_mask=attend,
                dropout_p=0.0 if deterministic else self.attn_drop.p)
        y = self.proj(y.transpose(1, 2).reshape(B, T, C))
        return _dropout(y, self.resid_drop, deterministic)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        C = cfg.n_embd
        self.LayerNorm_0 = LayerNorm(C, cfg.dtype)
        self.SelfAttention_0 = SelfAttention(cfg)
        self.LayerNorm_1 = LayerNorm(C, cfg.dtype)
        self.Dense_0 = Dense(C, 4 * C, cfg.dtype)
        self.Dense_1 = Dense(4 * C, C, cfg.dtype)
        self.drop = nn.Dropout(cfg.resid_pdrop)

    def forward(self, x: torch.Tensor, attend: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x), attend,
                                     deterministic)
        h = self.Dense_1(_gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + _dropout(h, self.drop, deterministic)


def _checkpointed(block: nn.Module, *args) -> torch.Tensor:
    """``block(*args)`` with its activations recomputed in the backward.
    The block's parameter tensors go in as explicit inputs: under
    ``torch.func.functional_call`` (E-MAML's per-task parameters) they are
    the caller's tensors, which the recomputation must use too."""
    names, tensors = zip(*block.named_parameters())

    def run(*xs):
        n = len(args)
        return torch.func.functional_call(
            block, dict(zip(names, xs[n:])), xs[:n])

    return checkpoint(run, *args, *tensors, use_reentrant=False)


class Periodic(nn.Module):
    """Random-Fourier-feature bbox encoder (GPTPolicy.py:115-126): x ->
    [cos(2 pi c x) | sin(2 pi c x)] per coordinate -> Dense -> GELU, with
    learnable frequencies drawn N(0, sigma)."""

    def __init__(self, d_in: int, n_freq: int, out: int, dtype: torch.dtype,
                 sigma: float = 0.15):
        super().__init__()
        self.sigma, self.dtype = sigma, dtype
        self.coefficients = _param(d_in, n_freq)
        self.encoder = Dense(d_in * 2 * n_freq, out, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        nn.init.normal_(self.coefficients, std=self.sigma,
                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [..., D] in [0,1]
        ang = 2 * math.pi * self.coefficients * x[..., None].to(torch.float32)
        feat = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        feat = feat.reshape(*x.shape[:-1], -1).to(self.dtype)
        return _gelu(self.encoder(feat))


class Head(nn.Module):
    """3-layer GELU head (GPTPolicy.py head_factory); the last layer
    computes in float32."""

    def __init__(self, out: int, cfg: GPTConfig):
        super().__init__()
        C = cfg.n_embd
        self.Dense_0 = Dense(C, C, cfg.dtype, ortho_gain=math.sqrt(2))
        self.Dense_1 = Dense(C, C, cfg.dtype, ortho_gain=math.sqrt(2))
        self.Dense_2 = Dense(C, out, torch.float32, ortho_gain=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_2(_gelu(self.Dense_1(_gelu(self.Dense_0(x)))))


class GPTPolicy(nn.Module):
    """Returns per-op tokens, op logits, value and the aux predictions.
    ``generator`` (a CPU ``torch.Generator``) makes the initial draw
    reproducible on any device."""

    def __init__(self, cfg: GPTConfig = GPTConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        C, dt = c.n_embd, c.dtype
        self.color_encoder = Embed(c.num_colors, C, dt)
        self.operation_encoder = Embed(c.num_actions, C, dt)
        self.trials_encoder = Embed(4, C, dt)
        self.active_encoder = Embed(2, C, dt)
        self.pos_emb = _param(1, c.num_pixel, C)
        self.state_emb = _param(8, 1, C)
        self.cls_tkn = _param(1, 1, C)
        self.color_action_tkn = _param(1, 1, C)
        if c.factorized:
            self.op_query_tkn = _param(1, 1, C)
            self.sel_query_tkn = _param(1, 1, C)
        self.bbox_encoder = Periodic(4, max(C // 8, 1), C, dt)
        self.embd_drop = nn.Dropout(c.embd_pdrop)
        for i in range(c.n_layer):
            setattr(self, f"block_{i}", Block(c))
        self.ln_f = LayerNorm(C, dt)
        sfx = "_f" if c.factorized else ""
        heads = {"operation": c.num_actions if c.factorized else 1,
                 "bbox_mean": 4, "bbox_std": 4}
        if c.bbox_bins:
            heads["bbox_logits"] = 4 * c.bbox_bins
        for name, out in heads.items():
            setattr(self, f"head_{name}{sfx}", Head(out, c))
        self.head_critic = Head(1, c)
        self.head_aux_rtm1 = Head(1, c)
        self.head_aux_reward = Head(1, c)
        self.head_aux_transition = Head(c.num_colors, c)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for name, p in self.named_parameters(recurse=False):
            nn.init.normal_(p, std=0.02, generator=generator)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.n_layer)]

    def forward(self, grid, grid_dim, inp, inp_dim, trials_remain, active,
                deterministic: bool = True,
                operation: Optional[torch.Tensor] = None,
                bbox: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """All arguments batched: grid / inp int ``[B, H, W]``, dims
        ``[B, 2]``, trials_remain / active ``[B]``.  ``operation`` (int
        ``[B]``) and ``bbox`` (float ``[B, 4]`` in [0, 1]) switch on the
        action-conditioned pass: the chosen op's embedding and a Periodic
        encoding of the bbox become two extra tokens after CLS, the r_t
        head reads the last of them, and the next-grid head reads grid
        tokens that attend to them."""
        c = self.cfg
        B, P, C, dt = grid.shape[0], c.num_pixel, c.n_embd, c.dtype
        nc = c.num_colors
        conditioned = operation is not None

        color = lambda g: self.color_encoder(
            torch.clamp(g.long(), 0, nc - 1).reshape(B, P))
        pe = self.pos_emb.to(dt)
        grid_t = color(grid) + pe + self.state_emb[0].to(dt)
        inp_t = color(inp) + pe + self.state_emb[6].to(dt)
        info = (self.trials_encoder(torch.clamp(trials_remain.long(), 0, 3))
                + self.active_encoder(torch.clamp(active.long(), 0, 1)))
        info = info.reshape(B, 1, C)

        op_w = self.operation_encoder.table()
        color_part = (self.color_action_tkn.to(dt)
                      + self.color_encoder.table()[None])     # [1, nc, C]
        # color_equivariant: the color-op tokens are the color part alone
        first = color_part if c.color_equivariant \
            else op_w[None, :nc] + color_part
        op_tokens = torch.cat([first, op_w[None, nc:]], dim=1).expand(
            B, -1, -1)
        tokens = [grid_t, inp_t, info, op_tokens,
                  self.cls_tkn.to(dt).expand(B, 1, C)]
        if c.factorized:
            tokens += [self.op_query_tkn.to(dt).expand(B, 1, C),
                       self.sel_query_tkn.to(dt).expand(B, 1, C)]
        if conditioned:
            op_cond = operation.long()
            enc_op = self.operation_encoder(op_cond)[:, None]
            if c.color_equivariant:
                # a color op's action token is the same function of the
                # color embedding as its policy token
                color_cond = (self.color_action_tkn[0].to(dt)
                              + self.color_encoder(
                                  torch.clamp(op_cond, 0, nc - 1))[:, None])
                enc_op = torch.where((op_cond < nc)[:, None, None],
                                     color_cond, enc_op)
            enc_bb = self.bbox_encoder(bbox.to(torch.float32))[:, None]
            tokens += [enc_op, enc_bb]
        x = torch.cat(tokens, dim=1)

        n_fixed = x.shape[1] - 2 * P
        attend = torch.cat([
            active_mask(grid_dim, c.grid_x, c.grid_y),
            active_mask(inp_dim, c.grid_x, c.grid_y),
            torch.ones((B, n_fixed), dtype=torch.bool, device=x.device)],
            dim=1)[:, None, None, :]

        x = _dropout(x, self.embd_drop, deterministic)
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks():
            x = _checkpointed(block, x, attend, deterministic) if remat \
                else block(x, attend, deterministic)
        x = self.ln_f(x)

        # token slots by absolute position (stable under appended tokens):
        # grid [0,P), input [P,2P), info 2P, ops, CLS, extras
        ops_at = 2 * P + 1
        cls_at = ops_at + c.num_actions
        op_x = x[:, ops_at:cls_at]
        cls_x = x[:, cls_at]
        # conditioned pass: r_t reads the final action token
        r_src = x[:, -1] if conditioned else cls_x

        out = {}
        if c.factorized:
            opq_x, selq_x = x[:, cls_at + 1], x[:, cls_at + 2]
            op_logits = self.head_operation_f(opq_x)
            per_op = lambda t: t[:, None].expand(B, c.num_actions,
                                                 *t.shape[1:])
            bbox_mean_all = per_op(self.head_bbox_mean_f(selq_x))
            bbox_std_all = per_op(self.head_bbox_std_f(selq_x))
            if c.bbox_bins:
                out["bbox_logits_all"] = per_op(
                    self.head_bbox_logits_f(selq_x).reshape(
                        B, 4, c.bbox_bins))
        else:
            op_logits = self.head_operation(op_x).squeeze(-1)
            bbox_mean_all = self.head_bbox_mean(op_x)
            bbox_std_all = self.head_bbox_std(op_x)
            if c.bbox_bins:
                out["bbox_logits_all"] = self.head_bbox_logits(op_x) \
                    .reshape(B, -1, 4, c.bbox_bins)
        out.update({
            "op_tokens": op_x.to(torch.float32),
            "op_logits": op_logits.to(torch.float32),
            "value": self.head_critic(cls_x).squeeze(-1),
            "aux_rtm1": self.head_aux_rtm1(cls_x).squeeze(-1),
            "aux_reward": self.head_aux_reward(r_src).squeeze(-1),
            "aux_transition": self.head_aux_transition(x[:, :P]),
            "bbox_mean_all": bbox_mean_all,
            "bbox_std_all": bbox_std_all,
        })
        return out
