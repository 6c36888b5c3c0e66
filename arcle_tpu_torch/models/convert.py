"""Weights and optimizer state carried across from the JAX package.

A flax param tree (``{"params": {...}}``) becomes the port's
``state_dict`` by renaming: the port's modules carry the flax names, so
``block_3/SelfAttention_0/qkv/kernel`` becomes
``block_3.SelfAttention_0.qkv.weight``.  ``Dense.kernel`` is ``[in,
out]`` where ``nn.Linear.weight`` is ``[out, in]``; ``LayerNorm.scale``
and ``Embed.embedding`` become ``weight``; every other leaf (``pos_emb``,
``coefficients``, ...) keeps its name.  The trees come in as numpy
arrays (or anything ``np.asarray`` takes); nothing here imports JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _state_dict_from_flax(params: Mapping[str, Any]
                          ) -> "OrderedDict[str, torch.Tensor]":
    tree = params["params"] if "params" in params else params
    out = OrderedDict()

    def walk(node, prefix):
        for name, sub in node.items():
            if isinstance(sub, Mapping):
                walk(sub, prefix + (name,))
                continue
            value = np.asarray(sub, dtype=np.float32)
            if name == "kernel":
                value = value.T
            key = ".".join(prefix + (_LEAF.get(name, name),))
            out[key] = torch.from_numpy(np.array(value, order="C"))

    walk(tree, ())
    return out


def fcpolicy_state_dict_from_flax(params: Mapping[str, Any]
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``FCPolicy`` param tree -> the port's ``state_dict``."""
    return _state_dict_from_flax(params)


def gpt_state_dict_from_flax(params: Mapping[str, Any]
                             ) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``GPTPolicy`` param tree -> the port's ``state_dict``."""
    return _state_dict_from_flax(params)


def dt_state_dict_from_flax(params: Mapping[str, Any]
                            ) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``DTPolicy`` param tree -> the port's ``state_dict``.  Its
    attention's ``DenseGeneral`` kernels are flattened first: ``query`` /
    ``key`` / ``value`` ``[C, H, D]`` to ``[C, H*D]`` and their ``[H, D]``
    biases to ``[H*D]``, ``out`` ``[H, D, C]`` to ``[H*D, C]``; the
    renaming then transposes them into ``nn.Linear`` weights."""
    def flatten(node, module=""):
        out = {}
        for name, sub in node.items():
            if isinstance(sub, Mapping):
                out[name] = flatten(sub, name)
                continue
            value = np.asarray(sub)
            if module in ("query", "key", "value"):
                value = value.reshape(value.shape[0], -1) \
                    if name == "kernel" else value.reshape(-1)
            elif module == "out" and name == "kernel":
                value = value.reshape(-1, value.shape[-1])
            out[name] = value
        return out

    tree = params["params"] if "params" in params else params
    return _state_dict_from_flax(flatten(tree))


def hypermlp_state_dict_from_flax(params: Mapping[str, Any]
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``HyperMLP`` (or ``WLinear``) param tree -> the port's
    ``state_dict``: ``wl_0/z`` keeps its name, ``wl_0/fc/kernel`` becomes
    ``wl_0.fc.weight`` (transposed)."""
    return _state_dict_from_flax(params)


def _find_adam(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (fields count, mu, nu) inside an optax
    chain's state."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_adam(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state: Any, model: nn.Module
                          ) -> Dict[nn.Parameter, Dict[str, torch.Tensor]]:
    """An optax state holding ``scale_by_adam`` (``adam``, clip+adam or
    ``adamw``) -> per-parameter ``torch.optim.Adam`` / ``AdamW`` state for
    ``model``'s parameters: ``optimizer.state.update(...)``.

    optax keeps the first and second moments ``mu`` / ``nu`` and one step
    ``count``; Adam and AdamW keep ``exp_avg`` / ``exp_avg_sq`` and
    ``step`` per parameter."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("adam_state_from_optax: no adam state (count, mu, "
                         "nu) in the optax state")
    mu = _state_dict_from_flax(adam.mu)
    nu = _state_dict_from_flax(adam.nu)
    step = float(np.asarray(adam.count))
    state = {}
    for name, p in model.named_parameters():
        state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": mu[name].to(p.device),
                    "exp_avg_sq": nu[name].to(p.device)}
    return state
