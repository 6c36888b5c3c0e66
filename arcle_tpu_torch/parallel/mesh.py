"""Device meshes, data sharding and tensor parallelism over
``torch.distributed``.

Counterpart of ``arcle_tpu/parallel/mesh.py``.  JAX has one controller:
``jax.device_put`` with a ``NamedSharding`` turns the same program into an
SPMD one, and XLA inserts the collectives.  Here every rank is a process
that holds only its own block, and the collectives are explicit:

* env-batch **data parallelism**: :func:`shard_leading` keeps this rank's
  contiguous block of every leading dimension the ``data`` axis divides
  (an env batch, its reset pool's slot-major rows, a trajectory's leading
  axis).  Stepping needs no collective; the learner's collectives are in
  :mod:`..training.ppo` (``group=``);
* **tensor parallelism** of wide linear layers over a ``model`` axis
  (:func:`shard_params_tp`): each rank holds a block of output features,
  and the layer all-gathers its output, so everything after it computes
  the unsharded function.

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over the
whole world; the process group must exist first
(:func:`~.multihost.init_multihost`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the process group; by default a 1-D
    ``data`` mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (call "
                           "init_multihost first)")
    shape = (dist.get_world_size(),) if shape is None else tuple(shape)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def data_model_mesh(n_model: int = 1, device_type: str = "cuda"
                    ) -> DeviceMesh:
    """A 2-D ``(data, model)`` mesh; ``model`` is the tensor-parallel
    axis."""
    n = dist.get_world_size()
    if n % n_model:
        raise ValueError(f"data_model_mesh: {n} ranks do not split into "
                         f"model groups of {n_model}")
    return make_mesh((n // n_model, n_model), ("data", "model"),
                     device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of dataclasses, named tuples, tuples, lists
    and dicts (the port's ``EnvState``, ``BatchedState``, ``ResetPool``,
    ``Action``, ``Trajectory``, ``PPOBatch``)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def rank_generator(gen: torch.Generator, index: int) -> torch.Generator:
    """A generator on ``gen``'s device seeded from ``(gen's seed,
    index)``."""
    seed = np.random.SeedSequence([gen.initial_seed(), index])
    return torch.Generator(device=gen.device).manual_seed(
        int(seed.generate_state(1)[0]))


def shard_block(tree: Any, size: int, index: int) -> Any:
    """Block ``index`` of ``size`` along every leading dimension that
    ``size`` divides; other leaves whole.  A generator becomes
    :func:`rank_generator` of it, so blocks draw different streams.  At
    ``size`` 1 the tree itself comes back."""
    if size == 1:
        return tree

    def cut(x):
        if isinstance(x, torch.Generator):
            return rank_generator(x, index)
        if torch.is_tensor(x) and x.ndim >= 1 and x.shape[0] % size == 0:
            per = x.shape[0] // size
            return x[index * per:(index + 1) * per].clone()
        return x

    return tree_map(cut, tree)


def shard_leading(tree: Any, mesh: DeviceMesh, axis: str = "data") -> Any:
    """This rank's block of every leaf's leading axis over ``axis``; a
    leaf whose leading dimension the axis size does not divide stays whole
    (JAX replicates it).  A reset pool's ``[B*K]`` rows are slot-major, so
    the cut keeps exactly this rank's slots.  A generator is reseeded per
    block of the axis (the JAX package's keys are per env and shard with
    the state; a torch generator serves a whole batch)."""
    return shard_block(tree, axis_size(mesh, axis),
                       mesh.get_local_rank(axis))


def _broadcast_(x: torch.Tensor, src: int) -> None:
    """In-place broadcast from global rank ``src`` (bool through
    ``uint8``, which the backends take)."""
    dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool else x, src)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every rank gets the mesh's first rank's values: a broadcast of
    every tensor (in place for a module's parameters and buffers)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("replicate: the mesh does not cover the process "
                         "group")
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                _broadcast_(t.data, src)
        return tree

    def put(x):
        if not torch.is_tensor(x):
            return x
        y = x.clone()
        _broadcast_(y, src)
        return y

    return tree_map(put, tree)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank's part comes from its block of features)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32).contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the feature blocks along the last axis (in float32,
    exactly, whatever the layer's dtype); the backward keeps this rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index, size):
        ctx.index, ctx.size = index, size
        part = y.to(torch.float32).contiguous()
        parts = [torch.empty_like(part) for _ in range(size)]
        dist.all_gather(parts, part, group=group)
        return torch.cat(parts, dim=-1).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, dim=-1)[ctx.index].contiguous(), None, \
            None, None


def is_tp_sharded(p: torch.Tensor) -> bool:
    """Whether ``p`` is a tensor-parallel block (set by
    :func:`shard_params_tp`)."""
    return getattr(p, "tp_group", None) is not None


def shard_params_tp(model: nn.Module, mesh: DeviceMesh, axis: str = "model",
                    min_cols: int = 256) -> nn.Module:
    """Column-parallel placement, in place: every ``nn.Linear`` with at
    least ``min_cols`` output features (flax's kernel columns) that the
    axis size divides keeps this rank's block of output features (rows of
    ``weight``, and of ``bias``) and all-gathers its output; everything
    else stays replicated.  A sharded parameter carries ``tp_group`` (the
    axis's process group), so the learner counts each block once in the
    gradient norm.  Build the optimizer after this call."""
    size = axis_size(mesh, axis)
    if size == 1:
        return model
    group, index = mesh.get_group(axis), mesh.get_local_rank(axis)
    for module in model.modules():
        if not isinstance(module, nn.Linear) or \
                module.out_features < min_cols or module.out_features % size:
            continue
        per = module.out_features // size
        rows = slice(index * per, (index + 1) * per)
        for name in ("weight", "bias"):
            full = getattr(module, name)
            if full is None:
                continue
            block = nn.Parameter(full.data[rows].clone(),
                                 requires_grad=full.requires_grad)
            block.tp_group = group
            setattr(module, name, block)
        module.out_features = per
        module.register_forward_pre_hook(
            lambda m, args, g=group: (_CopyToModel.apply(args[0], g),)
            + tuple(args[1:]))
        module.register_forward_hook(
            lambda m, args, out, g=group, i=index, n=size:
            _GatherFromModel.apply(out, g, i, n))
    return model
