"""Autoregressive (operation, bbox) action distribution.

Counterpart of ``arcle_tpu/models/bbox_dist.py`` (the reference's
``AROPandBBox``, bboxdist.py:20-66): a Categorical over the operation from
per-op tokens, then a TruncatedNormal over the 4 bbox coordinates
conditioned on the chosen op's head outputs (mu = sigmoid(head), sigma =
exp(clamp(head, min_log_std, 2)), support [0, 1]); coordinates are scaled
by the grid size and floored to ints.  A second head family samples each
coordinate from a categorical over the grid's bins.

The chosen op's row is taken with a gather, which gives the same element
as the JAX package's one-hot contraction.  Sampling draws from an explicit
``torch.Generator``, or takes injected noise: ``u_op`` (uniforms of the
Gumbel-max draw of the op, as :func:`models.mlp.gumbel_uniforms` draws
them) and ``u_bbox`` (uniforms of the bbox draw, in [1e-6, 1 - 1e-6) for
the truncated normal, or Gumbel uniforms for the categorical head).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import truncated_normal
from .mlp import gumbel_uniforms
from .truncated_normal import TruncatedNormal

MIN_LOG_STD, MAX_LOG_STD = -20.0, 2.0
I32 = torch.int32


class OpBBoxSample(NamedTuple):
    operation: torch.Tensor   # i32 [...]
    bbox: torch.Tensor        # i32 [..., 4]  (x1, y1, x2, y2)
    log_prob: torch.Tensor    # f32 [...]


def select_op(per_op: torch.Tensor, operation: torch.Tensor) -> torch.Tensor:
    """``per_op[..., operation, :]`` -> ``[..., D]``."""
    idx = operation.long()[..., None, None].expand(
        *operation.shape, 1, per_op.shape[-1])
    return torch.gather(per_op, -2, idx).squeeze(-2)


def op_log_softmax_at(op_logits: torch.Tensor,
                      operation: torch.Tensor) -> torch.Tensor:
    """``log_softmax(op_logits)[operation]``."""
    ls = F.log_softmax(op_logits, dim=-1)
    return torch.gather(ls, -1, operation.long()[..., None]).squeeze(-1)


def make_dist(mean_all: torch.Tensor, std_all: torch.Tensor,
              operation: torch.Tensor,
              min_log_std: float = MIN_LOG_STD) -> TruncatedNormal:
    """TruncatedNormal over [0,1]^4 from the chosen op's raw head outputs
    (``mean_all`` / ``std_all``: ``[..., n_ops, 4]``).  ``min_log_std``
    puts a floor under the std (the reference's -20 by default)."""
    mean = torch.sigmoid(select_op(mean_all, operation))
    std = torch.exp(torch.clamp(select_op(std_all, operation), min_log_std,
                                MAX_LOG_STD))
    return TruncatedNormal.create(mean, std, 0.0, 1.0)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator],
                 u: Optional[torch.Tensor]) -> torch.Tensor:
    """Gumbel-max draw ``argmax(logits - log(-log u))`` along the last
    axis, as ``jax.random.categorical`` draws."""
    if u is None:
        u = gumbel_uniforms(logits.shape, generator, logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def draw_uniforms(lead, n_ops: int, generator: Optional[torch.Generator],
                  device, bins: int = 0, u=None):
    """``(u_op, u_bbox)``: the uniforms a draw of ``n_ops`` operations and
    a bbox over a batch of shape ``lead`` takes from ``generator``, in the
    order the samplers draw them: the op's Gumbel uniforms ``[*lead,
    n_ops]``, then the bbox's, truncated-normal ``[*lead, 4]`` or, for a
    categorical head of ``bins`` bins, Gumbel ``[*lead, 4, bins]``.  The
    entries of ``u`` that are not None are kept, and draw nothing."""
    u_op, u_bbox = (None, None) if u is None else u
    if u_op is None:
        u_op = gumbel_uniforms((*lead, n_ops), generator, device)
    if u_bbox is None:
        u_bbox = gumbel_uniforms((*lead, 4, bins), generator, device) \
            if bins else truncated_normal.sample_uniforms((*lead, 4),
                                                          generator, device)
    return u_op, u_bbox


def sample(op_logits: torch.Tensor, mean_all: torch.Tensor,
           std_all: torch.Tensor, grid_size: int = 30,
           deterministic: bool = False, min_log_std: float = MIN_LOG_STD,
           quantized_log_prob: bool = False,
           generator: Optional[torch.Generator] = None,
           u_op: Optional[torch.Tensor] = None,
           u_bbox: Optional[torch.Tensor] = None) -> OpBBoxSample:
    """op ~ Categorical(logits); bbox ~ TruncNorm(head(op)) * size, floored
    (bboxdist.py:29-49).  ``deterministic`` takes the argmax op and the
    distribution's mean.  ``quantized_log_prob`` evaluates the log-prob at
    the discretised bbox instead of the continuous draw."""
    if deterministic:
        operation = torch.argmax(op_logits, dim=-1)
    else:
        operation = _categorical(op_logits, generator, u_op)
    lp_op = op_log_softmax_at(op_logits, operation)
    dist = make_dist(mean_all, std_all, operation, min_log_std)
    u = dist.mean() if deterministic else dist.sample(generator, u=u_bbox)
    u = torch.clamp(u, 0.0, 1.0)
    bbox = torch.clamp(torch.floor(u * grid_size), 0,
                       grid_size - 1).to(I32)
    u_eval = bbox.to(torch.float32) / grid_size if quantized_log_prob else u
    lp = lp_op + dist.log_prob(u_eval).sum(-1)
    return OpBBoxSample(operation.to(I32), bbox, lp)


def log_prob(op_logits: torch.Tensor, mean_all: torch.Tensor,
             std_all: torch.Tensor, operation: torch.Tensor,
             bbox: torch.Tensor, grid_size: int = 30,
             min_log_std: float = MIN_LOG_STD) -> torch.Tensor:
    """log p(op, bbox) of stored integer actions, the continuous value taken
    as bbox / size (bboxdist.py:51-60)."""
    lp_op = op_log_softmax_at(op_logits, operation)
    dist = make_dist(mean_all, std_all, operation, min_log_std)
    u = bbox.to(torch.float32) / grid_size
    return lp_op + dist.log_prob(u).sum(-1)


def _categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    ls = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(ls) * ls, dim=-1)


def entropy(op_logits: torch.Tensor, mean_all: torch.Tensor,
            std_all: torch.Tensor, operation: torch.Tensor,
            min_log_std: float = MIN_LOG_STD) -> torch.Tensor:
    dist = make_dist(mean_all, std_all, operation, min_log_std)
    return _categorical_entropy(op_logits) + dist.entropy().sum(-1)


# ---------------------------------------------------------------------------
# Discrete selection head: a categorical over the grid's bins per bbox
# coordinate (the answer-given benchmark's head), after the same op draw.
# ---------------------------------------------------------------------------
def _select_op_logits(bbox_logits_all: torch.Tensor,
                      operation: torch.Tensor) -> torch.Tensor:
    """``[..., n_ops, 4, bins]`` -> the chosen op's ``[..., 4, bins]``."""
    *lead, n, four, bins = bbox_logits_all.shape
    flat = bbox_logits_all.reshape(*lead, n, four * bins)
    return select_op(flat, operation).reshape(*lead, four, bins)


def _log_softmax_at(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    ls = F.log_softmax(logits, dim=-1)
    return torch.gather(ls, -1, idx.long()[..., None]).squeeze(-1)


def sample_categorical(op_logits: torch.Tensor,
                       bbox_logits_all: torch.Tensor,
                       deterministic: bool = False,
                       generator: Optional[torch.Generator] = None,
                       u_op: Optional[torch.Tensor] = None,
                       u_bbox: Optional[torch.Tensor] = None
                       ) -> OpBBoxSample:
    if deterministic:
        operation = torch.argmax(op_logits, dim=-1)
    else:
        operation = _categorical(op_logits, generator, u_op)
    lp_op = op_log_softmax_at(op_logits, operation)
    bl = _select_op_logits(bbox_logits_all, operation)    # [..., 4, bins]
    if deterministic:
        coords = torch.argmax(bl, dim=-1)
    else:
        coords = _categorical(bl, generator, u_bbox)
    lp_bb = _log_softmax_at(bl, coords)
    return OpBBoxSample(operation.to(I32), coords.to(I32),
                        lp_op + lp_bb.sum(-1))


def log_prob_categorical(op_logits: torch.Tensor,
                         bbox_logits_all: torch.Tensor,
                         operation: torch.Tensor,
                         bbox: torch.Tensor) -> torch.Tensor:
    lp_op = op_log_softmax_at(op_logits, operation)
    bl = _select_op_logits(bbox_logits_all, operation)
    return lp_op + _log_softmax_at(bl, bbox).sum(-1)


def entropy_categorical(op_logits: torch.Tensor,
                        bbox_logits_all: torch.Tensor,
                        operation: torch.Tensor) -> torch.Tensor:
    bl = _select_op_logits(bbox_logits_all, operation)
    return _categorical_entropy(op_logits) + \
        _categorical_entropy(bl).sum(-1)
