"""Truncated normal distribution.

Counterpart of ``arcle_tpu/models/truncated_normal.py``: Normal(loc,
scale) truncated to [low, high], sampled by the inverse CDF of a uniform
restricted to the truncation interval, with the clamps of the JAX package
kept as written.  Used by the autoregressive bbox head (bbox_dist.py).

``log_prob`` keeps the reference's behaviour as sigma -> e^-20: the
standardised bounds overflow and the normaliser clamps at ``_EPS``, so the
log-prob grows without bound (ROADMAP queue 3).  The port matches that
semantics on purpose.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch.special import erf, erfinv

_SQRT2 = math.sqrt(2.0)
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_EPS = 1e-6


def _phi_cdf(x):
    return 0.5 * (1.0 + erf(x / _SQRT2))


def _phi_icdf(p):
    return _SQRT2 * erfinv(2.0 * p - 1.0)


def _phi(x):
    return torch.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


def sample_uniforms(shape, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """Uniforms in [_EPS, 1 - _EPS), as the JAX package draws them."""
    u = torch.rand(shape, generator=generator, device=device)
    return _EPS + u * (1.0 - 2 * _EPS)


@dataclasses.dataclass(frozen=True)
class TruncatedNormal:
    """Normal(loc, scale) truncated to [low, high]."""

    loc: torch.Tensor
    scale: torch.Tensor
    low: torch.Tensor
    high: torch.Tensor

    @staticmethod
    def create(loc, scale, low=0.0, high=1.0) -> "TruncatedNormal":
        loc, scale = torch.as_tensor(loc), torch.as_tensor(scale)
        full = lambda v: torch.full_like(loc, v) if not torch.is_tensor(v) \
            else v.to(loc.dtype).expand(loc.shape)
        return TruncatedNormal(loc=loc, scale=scale, low=full(low),
                               high=full(high))

    # standardised bounds
    @property
    def _alpha(self):
        return (self.low - self.loc) / self.scale

    @property
    def _beta(self):
        return (self.high - self.loc) / self.scale

    @property
    def _z(self):
        return torch.clamp(_phi_cdf(self._beta) - _phi_cdf(self._alpha),
                           min=_EPS)

    def sample(self, generator: Optional[torch.Generator] = None,
               sample_shape: Sequence[int] = (),
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A draw of shape ``sample_shape + loc.shape``; ``u`` injects the
        uniforms in [_EPS, 1 - _EPS)."""
        if u is None:
            shape = tuple(sample_shape) + tuple(torch.broadcast_shapes(
                self.loc.shape, self.scale.shape))
            u = sample_uniforms(shape, generator, self.loc.device)
        p = _phi_cdf(self._alpha) + u * self._z
        x = self.loc + self.scale * _phi_icdf(torch.clamp(p, _EPS,
                                                          1.0 - _EPS))
        return torch.minimum(torch.maximum(x, self.low), self.high)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        log_unnorm = -0.5 * z * z - _LOG_SQRT_2PI - torch.log(self.scale)
        return log_unnorm - torch.log(self._z)

    def mean(self) -> torch.Tensor:
        a, b = self._alpha, self._beta
        return self.loc + self.scale * (_phi(a) - _phi(b)) / self._z

    def entropy(self) -> torch.Tensor:
        a, b = self._alpha, self._beta
        z = self._z
        frac = (a * _phi(a) - b * _phi(b)) / z
        return 0.5 + _LOG_SQRT_2PI + torch.log(self.scale * z) + 0.5 * frac
