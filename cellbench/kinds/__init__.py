"""How each kind of configuration is built: its parameters (names,
shapes and the draw that fills them), the port's objects for each driver,
and the reference's policy, env and task bank.  A configuration file names
its kind; a new configuration of a kind that exists is a data file."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

ParamSpec = Tuple[str, Tuple[int, ...], str, float]   # name, shape, init, scale


def draw_weights(specs: List[ParamSpec], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The weights of ``specs`` from ``seed``, on ``device`` in float32, in
    one draw: ``("normal", std)`` leaves take a slice of it scaled by
    ``std``, ``("const", v)`` leaves are filled with ``v``."""
    n = sum(_numel(s) for _, s, init, _ in specs if init == "normal")
    g = torch.Generator(device=device).manual_seed(mix(seed, 0x5eed))
    flat = torch.randn(n, generator=g, device=device)
    out, at = {}, 0
    for name, shape, init, scale in specs:
        k = _numel(shape)
        if init == "normal":
            out[name] = (flat[at:at + k] * scale).view(shape).clone()
            at += k
        else:
            out[name] = torch.full(shape, float(scale), device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def mix(seed: int, salt: int) -> int:
    """A 63-bit seed for one stream of the run's draws."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) \
        % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)
