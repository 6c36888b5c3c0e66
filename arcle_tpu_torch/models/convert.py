"""Weights and optimizer state carried across from the JAX package.

``arcle_tpu``'s :class:`FCPolicy` params are a flax tree
``{"params": {"fc_0": {"kernel", "bias"}, ..., "pi": ..., "vf": ...}}``
whose ``Dense.kernel`` is ``[in, out]``; ``nn.Linear.weight`` is
``[out, in]``.  The trees come in as numpy arrays (or anything
``np.asarray`` takes); nothing here imports JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


def fcpolicy_state_dict_from_flax(params: Mapping[str, Any]
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """A flax ``FCPolicy`` param tree -> the port's ``state_dict``."""
    tree = params["params"] if "params" in params else params
    out = OrderedDict()
    for layer, leaves in tree.items():
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        out[f"{layer}.weight"] = torch.from_numpy(
            np.array(kernel.T, order="C"))
        out[f"{layer}.bias"] = torch.from_numpy(
            np.array(leaves["bias"], dtype=np.float32))
    return out


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
    """The optax clip+adam state -> per-parameter ``torch.optim.Adam``
    state for ``model``'s parameters: ``optimizer.state.update(...)``.

    optax keeps the first and second moments ``mu`` / ``nu`` and one step
    ``count``; Adam keeps ``exp_avg`` / ``exp_avg_sq`` and ``step`` per
    parameter."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("adam_state_from_optax: no adam state (count, mu, "
                         "nu) in the optax state")
    mu = fcpolicy_state_dict_from_flax(adam.mu)
    nu = fcpolicy_state_dict_from_flax(adam.nu)
    step = float(np.asarray(adam.count))
    state = {}
    for name, p in model.named_parameters():
        state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                    "exp_avg": mu[name].to(p.device),
                    "exp_avg_sq": nu[name].to(p.device)}
    return state
