"""Grid geometry on batched tensors.

Counterpart of ``arcle_tpu/core/geometry.py``.  Positions are signed and
per env; a per-env circular shift is a gather with floor-mod indices
(``torch.remainder``), so a window placed partly off-grid behaves exactly
as the JAX package's roll-based placement.  Every function takes the batch
axis first: grids ``[B,H,W]``, per-env scalars ``[B]``.
"""

from __future__ import annotations

from typing import Tuple

import torch

I32 = torch.int32
I8 = torch.int8


def row_col_iota(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 ``[1,H,1]`` row and ``[1,1,W]`` column indices (broadcastable
    against ``[B,H,W]``)."""
    rows = torch.arange(H, dtype=I32, device=device).view(1, H, 1)
    cols = torch.arange(W, dtype=I32, device=device).view(1, 1, W)
    return rows, cols


def _b(v: torch.Tensor) -> torch.Tensor:
    """A per-env ``[B]`` value as ``[B,1,1]`` int32."""
    return v.to(I32).view(-1, 1, 1)


def inside_dims(dim: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bool ``[B,H,W]``: row < dim[:,0] and col < dim[:,1]."""
    rows, cols = row_col_iota(H, W, dim.device)
    return (rows < _b(dim[:, 0])) & (cols < _b(dim[:, 1]))


def bbox(mask: torch.Tensor):
    """Bounding box of the truthy cells of each ``[H,W]`` mask.

    Returns ``(any, rmin, rmax, cmin, cmax)``: bool ``[B]`` and int32
    ``[B]``, zeros where the mask is empty (callers gate on ``any``).
    """
    m = mask != 0
    B, H, W = m.shape
    rows_any = m.any(dim=2)
    cols_any = m.any(dim=1)
    ridx = torch.arange(H, dtype=I32, device=m.device).view(1, H)
    cidx = torch.arange(W, dtype=I32, device=m.device).view(1, W)
    big = torch.tensor(H * W, dtype=I32, device=m.device)
    neg = torch.tensor(-1, dtype=I32, device=m.device)
    rmin = torch.where(rows_any, ridx, big).amin(dim=1)
    rmax = torch.where(rows_any, ridx, neg).amax(dim=1)
    cmin = torch.where(cols_any, cidx, big).amin(dim=1)
    cmax = torch.where(cols_any, cidx, neg).amax(dim=1)
    nonempty = rows_any.any(dim=1)
    z = torch.zeros((), dtype=I32, device=m.device)
    return (nonempty, torch.where(nonempty, rmin, z),
            torch.where(nonempty, rmax, z), torch.where(nonempty, cmin, z),
            torch.where(nonempty, cmax, z))


def roll_axis(a: torch.Tensor, shift: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-env circular shift along ``axis`` (1 = rows, 2 = columns):
    ``out[b, i] = a[b, (i - shift[b]) mod n]``, as ``jnp.roll`` per env."""
    n = a.shape[axis]
    idx = torch.arange(n, dtype=torch.int64, device=a.device)
    src = torch.remainder(idx.view(1, n) - shift.to(torch.int64).view(-1, 1), n)
    shape = [a.shape[0], 1, 1]
    shape[axis] = n
    return torch.gather(a, axis, src.view(shape).expand(a.shape))


def shift2d(a: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``out[b,i,j] = a[b, (i-dx[b]) mod H, (j-dy[b]) mod W]``."""
    return roll_axis(roll_axis(a, dx, 1), dy, 2)


def window_mask(x, y, h, w, H: int, W: int) -> torch.Tensor:
    """Bool ``[B,H,W]``: x <= i < x+h and y <= j < y+w (signed, per env)."""
    rows, cols = row_col_iota(H, W, x.device)
    x, y, h, w = _b(x), _b(y), _b(h), _b(w)
    return (rows >= x) & (rows < x + h) & (cols >= y) & (cols < y + w)


def place_patch(patch: torch.Tensor, h, w, x, y, limit_h, limit_w):
    """Shift origin-anchored ``h x w`` patches to signed positions (x, y).

    Returns ``(values, valid)`` with ``values[b,i,j] = patch[b,i-x,j-y]``
    (circularly) and ``valid`` marking 0 <= i-x < h, 0 <= j-y < w,
    i < limit_h, j < limit_w.
    """
    _, H, W = patch.shape
    vals = shift2d(patch, x, y)
    m = window_mask(x, y, h, w, H, W)
    rows, cols = row_col_iota(H, W, patch.device)
    m = m & (rows < _b(limit_h)) & (cols < _b(limit_w))
    return vals, m


def bbox_selection(x1, y1, x2, y2, H: int, W: int) -> torch.Tensor:
    """Rectangular int8 ``[B,H,W]`` selections from two corners per env
    (order-free; reference wrappers/bbox.py:22-30)."""
    x1, y1, x2, y2 = (torch.as_tensor(v).to(I32) for v in (x1, y1, x2, y2))
    xa, xb = _b(torch.minimum(x1, x2)), _b(torch.maximum(x1, x2))
    ya, yb = _b(torch.minimum(y1, y2)), _b(torch.maximum(y1, y2))
    rows, cols = row_col_iota(H, W, x1.device)
    return ((rows >= xa) & (rows <= xb) & (cols >= ya) & (cols <= yb)).to(I8)


def bbox_selection_flat(x1, y1, x2, y2, H: int, W: int) -> torch.Tensor:
    """:func:`bbox_selection` as flat int8 ``[B, H*W]`` masks."""
    return bbox_selection(x1, y1, x2, y2, H, W).reshape(-1, H * W)


def point_selection(x, y, H: int, W: int) -> torch.Tensor:
    """One-pixel int8 ``[B,H,W]`` selections (wrappers/bbox.py:43-49)."""
    x, y = torch.as_tensor(x).to(I32), torch.as_tensor(y).to(I32)
    rows, cols = row_col_iota(H, W, x.device)
    return ((rows == _b(x)) & (cols == _b(y))).to(I8)


def point_selection_flat(x, y, H: int, W: int) -> torch.Tensor:
    """One-pixel flat int8 ``[B, H*W]`` selections: lane ``x*W + y``
    (equal to :func:`point_selection` for in-range points)."""
    x, y = torch.as_tensor(x).to(I32), torch.as_tensor(y).to(I32)
    lane = torch.arange(H * W, dtype=I32, device=x.device).view(1, H * W)
    return (lane == (x * W + y).view(-1, 1)).to(I8)
