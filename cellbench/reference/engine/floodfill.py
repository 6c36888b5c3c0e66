"""Connected-component flood fill on batched masks.

Counterpart of ``arcle_tpu/core/floodfill.py``.  A sweep propagates a
mask along whole rows and then whole columns: within a line, a cell of the
region is reached when a seed lies in the same run of region cells.  With
run ids from a cumulative sum of the non-region cells, a prefix max of the
seeds' run ids (and a suffix min for the other direction) finds them.
Each sweep resolves one straight leg of any path; the fixpoint loop runs
sweeps until the whole batch stops changing.  The result is a set, so any
order of propagation gives the same bits.
"""

from __future__ import annotations

import torch

from .geometry import inside_dims, row_col_iota


def _propagate_axis(mask: torch.Tensor, region: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """One forward+backward reachability pass along ``axis`` (-1: along
    rows, -2: along columns) of bool ``[..., H, W]`` masks."""
    seed = mask & region
    run_id = torch.cumsum((~region).to(torch.int32), dim=axis)
    neg = torch.tensor(-1, dtype=run_id.dtype, device=run_id.device)
    big = torch.tensor(1 << 20, dtype=run_id.dtype, device=run_id.device)
    fwd = torch.cummax(torch.where(seed, run_id, neg), dim=axis).values == run_id
    rev = torch.flip(torch.where(seed, run_id, big), dims=(axis,))
    bwd = torch.flip(torch.cummin(rev, dim=axis).values, dims=(axis,)) == run_id
    return mask | (region & (fwd | bwd))


def sweep(mask: torch.Tensor, region: torch.Tensor) -> torch.Tensor:
    """One full propagation sweep (rows then columns)."""
    m = _propagate_axis(mask, region, -1)
    return _propagate_axis(m, region, -2)


def connected_component_partial(region: torch.Tensor, seed_mask: torch.Tensor,
                                unroll: int = 2):
    """``unroll`` sweeps with no control flow.

    Returns ``(mask, converged)``; ``converged`` (bool ``[B]``) is exact:
    the component is complete iff no region cell outside the mask is a
    4-neighbour of it.
    """
    region = region != 0
    mask = (seed_mask != 0) & region
    for _ in range(unroll):
        mask = sweep(mask, region)
    nb = torch.zeros_like(mask)
    nb[..., 1:, :] |= mask[..., :-1, :]
    nb[..., :-1, :] |= mask[..., 1:, :]
    nb[..., :, 1:] |= mask[..., :, :-1]
    nb[..., :, :-1] |= mask[..., :, 1:]
    frontier = region & ~mask & nb
    converged = ~frontier.flatten(-2).any(dim=-1)
    return mask, converged


def connected_component(region: torch.Tensor,
                        seed_mask: torch.Tensor) -> torch.Tensor:
    """Bool ``[B,H,W]``: cells of ``region`` 4-connected to a cell of
    ``seed_mask`` (the seed is intersected with the region first).

    Sweeps until no mask in the batch changes; the loop's condition is read
    on the host, so this is the plain (CPU) path's fixpoint.
    """
    region = region != 0
    mask = (seed_mask != 0) & region
    while True:
        m2 = sweep(mask, region)
        if torch.equal(m2, mask):
            return mask
        mask = m2


def flood_region(grid: torch.Tensor, grid_dim: torch.Tensor,
                 x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Same-color 4-connected region of seed (x, y) per env, restricted to
    cells inside ``grid_dim`` (the reference ``dfs``, color.py:8-30)."""
    B, H, W = grid.shape
    ar = torch.arange(B, device=grid.device)
    x, y = x.to(torch.int64), y.to(torch.int64)
    seed_color = grid[ar, x, y].view(B, 1, 1)
    region = (grid == seed_color) & inside_dims(grid_dim, H, W)
    rows, cols = row_col_iota(H, W, grid.device)
    seed = (rows == x.view(B, 1, 1)) & (cols == y.view(B, 1, 1))
    return connected_component(region, seed)
