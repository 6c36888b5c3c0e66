"""Frozen yardsticks: the model FLOPs a configuration's algorithm needs
(``flops``), the bytes one step of the step kernel must move
(``step_kernel_bytes``) and the card's published peaks (``peaks.json``).
They live with the benchmark so that no later change to the port can move
them."""

from __future__ import annotations

import json
from pathlib import Path


def peaks(card: str) -> dict:
    """The published dense peaks of ``card`` (a CUDA device name), or
    ``{}`` for a card not listed: a guessed peak would give a guessed
    share."""
    table = json.loads((Path(__file__).with_name("peaks.json")).read_text())
    for key, p in table["cards"].items():
        if key in card:
            return p
    return {}
