"""The MLP policy and its multi-categorical action heads.

Counterpart of ``arcle_tpu/models/mlp.py``: :class:`FCPolicy` is the fcnet
of the reference's MLP runs (train.py:97-100: [1024,1024,512,512,256,128]
tanh) with one categorical head per element of the BBoxWrapper action
tuple (x1: H, y1: W, x2: H, y2: W, op: n_ops) and a value head.

The heads are stacked into one ``[..., 5, N]`` tensor padded with -inf, so
sampling, log-prob and entropy are one pass over all five heads.

:class:`WLinear` / :class:`HyperMLP` are the hypernetwork-style linear
layers (weights generated from a learned latent ``z``) of the reference's
MLPPolicy (agents/models/MLPPolicy.py:6-34).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

I32 = torch.int32

# flax's lecun_normal draws from a normal truncated to [-2, 2] whose
# standard deviation is rescaled to sqrt(1/fan_in): this factor is the
# standard deviation of the truncated unit normal
_TRUNC_STD = 0.87962566103423978


def obs_width(H: int = 30, W: int = 30) -> int:
    """Width of the flattened FilterO2ARC observation: three grids, four
    dim pairs and two scalars (2710 at 30x30)."""
    return 3 * H * W + 10


class FCPolicy(nn.Module):
    """Tanh MLP torso ``fc_0..fc_{n-1}`` + multi-categorical logits ``pi``
    + value head ``vf``.  ``forward(obs)`` takes int8 (or any numeric)
    ``[..., obs_dim]`` observations and returns ``(logits_tuple, value)``.

    Weights are initialised as flax initialises the JAX policy: torso
    kernels lecun-normal (truncated), ``pi`` orthogonal with gain 0.01,
    ``vf`` orthogonal with gain 1.0, zero biases; ``generator`` (a CPU
    ``torch.Generator``) makes the draw reproducible on any device.

    ``dtype`` is the torso's compute dtype, as flax's ``Dense(dtype=)``:
    the parameters stay float32, each torso layer casts its input, kernel
    and bias to ``dtype`` (``torch.bfloat16`` runs the torso on the tensor
    cores), and the ``pi`` / ``vf`` heads compute in float32.
    """

    def __init__(self, hidden: Sequence[int] = (1024, 1024, 512, 512, 256,
                                                128),
                 n_ops: int = 35, H: int = 30, W: int = 30,
                 dtype: torch.dtype = torch.float32,
                 obs_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = tuple(hidden)
        self.dtype = dtype
        self.sizes = (H, W, H, W, n_ops)
        widths = [obs_width(H, W) if obs_dim is None else obs_dim,
                  *self.hidden]
        for i in range(len(self.hidden)):
            setattr(self, f"fc_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.pi = nn.Linear(widths[-1], sum(self.sizes))
        self.vf = nn.Linear(widths[-1], 1)
        self.reset_parameters(generator)

    @property
    def obs_dim(self) -> int:
        return (self.fc_0 if self.hidden else self.pi).in_features

    def torso(self):
        return [getattr(self, f"fc_{i}") for i in range(len(self.hidden))]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        for layer in self.torso():
            std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
        nn.init.orthogonal_(self.pi.weight, gain=0.01, generator=generator)
        nn.init.orthogonal_(self.vf.weight, gain=1.0, generator=generator)
        for layer in self.torso() + [self.pi, self.vf]:
            nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        dt = self.dtype
        x = obs.to(dt)
        for layer in self.torso():
            x = torch.tanh(F.linear(x, layer.weight.to(dt),
                                    layer.bias.to(dt)))
        x = x.to(torch.float32)
        logits = self.pi(x)
        value = self.vf(x).squeeze(-1)
        return tuple(torch.split(logits, self.sizes, dim=-1)), value


def stack_padded_logits(logits_tuple) -> torch.Tensor:
    """Stack heads of unequal width into one ``[..., heads, N]`` tensor,
    padded with -inf (classes that cannot be drawn)."""
    n = max(l.shape[-1] for l in logits_tuple)
    return torch.stack([F.pad(l, (0, n - l.shape[-1]), value=-math.inf)
                        for l in logits_tuple], dim=-2)


def gumbel_uniforms(shape, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """Uniforms in [1e-12, 1) for the Gumbel-max draw."""
    return torch.rand(shape, generator=generator,
                      device=device).clamp_(min=1e-12)


def multi_categorical_uniforms(sizes: Sequence[int], lead: Sequence[int],
                               generator: Optional[torch.Generator],
                               device) -> torch.Tensor:
    """The uniforms :func:`multi_categorical_sample` draws for heads of
    ``sizes`` over a batch of shape ``lead``: ``[*lead, heads, max(sizes)]``
    (the padded logits' shape), by :func:`gumbel_uniforms`."""
    return gumbel_uniforms((*lead, len(sizes), max(sizes)), generator,
                           device)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, idx.long().unsqueeze(-1)).squeeze(-1)


def multi_categorical_sample(logits_tuple,
                             generator: Optional[torch.Generator] = None,
                             u: Optional[torch.Tensor] = None):
    """Gumbel-max draw of every head: ``argmax(L - log(-log u))``, first
    index on ties.  ``u`` injects the uniforms (``[..., heads, N]``).
    Returns ``(actions int32 [..., heads], log_prob [...])``."""
    L = stack_padded_logits(logits_tuple)
    if u is None:
        u = gumbel_uniforms(L.shape, generator, L.device)
    g = -torch.log(-torch.log(u))
    a = torch.argmax(L + g, dim=-1).to(I32)
    lp = _take(F.log_softmax(L, dim=-1), a)
    return a, lp.sum(-1)


def multi_categorical_log_prob(logits_tuple, actions: torch.Tensor
                               ) -> torch.Tensor:
    L = stack_padded_logits(logits_tuple)
    return _take(F.log_softmax(L, dim=-1),
                 actions[..., :L.shape[-2]]).sum(-1)


def multi_categorical_entropy(logits_tuple) -> torch.Tensor:
    L = stack_padded_logits(logits_tuple)
    ls = F.log_softmax(L, dim=-1)
    p = torch.exp(ls)
    # zero the -inf entries before the multiply: p * (-inf) is NaN, and its
    # derivative poisons the backward pass even behind a where()
    ls_safe = torch.where(torch.isfinite(ls), ls, torch.zeros_like(ls))
    return -torch.sum(p * ls_safe, dim=(-2, -1))


class WLinear(nn.Module):
    """Linear layer whose weights are generated from a learned latent ``z``
    (MLPPolicy.py:6-34): ``theta = fc(z)``; ``y = x @ W + b`` with ``W`` the
    first ``in * out`` entries of ``theta`` as ``[in, out]`` and ``b`` the
    rest.  The latent is the only fast-adapted parameter of the
    hypernetwork variant.  Initialised as flax does: ``z`` ~ N(0,
    1/out_features), ``fc`` lecun-normal (truncated) with a zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 z_dim: int = 1000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.z = nn.Parameter(torch.empty(z_dim))
        self.fc = nn.Linear(z_dim, in_features * out_features + out_features)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        nn.init.normal_(self.z, std=1.0 / self.out_features,
                        generator=generator)
        std = math.sqrt(1.0 / self.fc.in_features) / _TRUNC_STD
        nn.init.trunc_normal_(self.fc.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        theta = self.fc(self.z)
        w_sz = self.in_features * self.out_features
        w = theta[:w_sz].reshape(self.in_features, self.out_features)
        return x @ w + theta[w_sz:]


class HyperMLP(nn.Module):
    """Stack of :class:`WLinear` layers ``wl_0..wl_{n-1}`` with tanh, then
    ``wl_out`` (the reference MLPPolicy's shape).  flax reads the input
    width off the first call; here it is ``in_features``."""

    def __init__(self, in_features: int, widths: Sequence[int], out: int,
                 z_dim: int = 1000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = tuple(widths)
        d = in_features
        for i, w in enumerate(self.widths):
            setattr(self, f"wl_{i}", WLinear(d, w, z_dim, generator))
            d = w
        self.wl_out = WLinear(d, out, z_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.widths)):
            x = torch.tanh(getattr(self, f"wl_{i}")(x))
        return self.wl_out(x)
