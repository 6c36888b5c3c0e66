"""ANSI terminal rendering of env states (numpy only).

The port's copy of ``arcle_tpu/utils/render.py``: the reference's
256-color painters (base.py:199-224 and the two-pane O2ARC variant,
o2arcenv.py:154-193): working grid with logical dims, selection markers
``[]``, and the clipboard pane.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# ARC color -> ANSI 256 code (base.py:20)
ANSI256_ARC = [0, 12, 9, 10, 11, 8, 13, 208, 14, 52]


def _cell(color: int, marker: str = "  ") -> str:
    return f"\033[48;5;{ANSI256_ARC[int(color)]}m{marker}"


def render_ansi_core(obs: Dict, description: Dict, op_name: str,
                     reward: float, first: bool = False,
                     out=None) -> str:
    """Single-pane render (RawARCEnv layout)."""
    grid = np.asarray(obs["grid"])
    gd = np.asarray(obs["grid_dim"])
    H, W = grid.shape
    lines = []
    if first:
        lines.append("\033[2J")
    lines.append(f"\033[{H + 3}A\033[K")
    lines.append("Problem Description:")
    lines.append(f"{description} \033[K")
    for i in range(H):
        row = []
        for j in range(W):
            if i >= gd[0] or j >= gd[1]:
                row.append("\033[47m  ")
            else:
                row.append(_cell(grid[i, j]))
        row.append("\033[0m")
        lines.append("".join(row))
    lines.append(f"Dimension : {gd} Action : {op_name} "
                 f"Reward : {reward}\033[K")
    text = "\n".join(lines)
    print(text, file=out)
    return text


def render_ansi_o2(obs: Dict, description: Dict, op_name: str,
                   reward: float, sel_flag: bool, first: bool = False,
                   out=None) -> str:
    """Two-pane render: grid (with [] selection markers) + clipboard."""
    grid = np.asarray(obs["grid"])
    gd = np.asarray(obs["grid_dim"])
    sel = np.asarray(obs["selected"])
    clip = np.asarray(obs["clip"])
    cd = np.asarray(obs["clip_dim"])
    H, W = grid.shape
    lines = []
    if first:
        lines.append("\033[2J")
    lines.append(f"\033[{H + 3}A\033[K")
    lines.append("Problem Description:")
    lines.append(f"{description} \033[K")
    for i in range(H):
        row = []
        for j in range(W):
            marker = "[]" if sel[i, j] else "  "
            if i >= gd[0] or j >= gd[1]:
                row.append(f"\033[47m{marker}")
            else:
                row.append(_cell(grid[i, j], marker))
        row.append("\033[0m  ")
        for j in range(W):
            if i >= cd[0] or j >= cd[1]:
                row.append("\033[47m  ")
            else:
                row.append(_cell(clip[i, j]))
        row.append("\033[0m")
        lines.append("".join(row))
    lines.append(f"Dimension : {gd} Action : {op_name} "
                 f"Selected : {sel_flag} Reward : {reward}\033[K")
    text = "\n".join(lines)
    print(text, file=out)
    return text
