"""Checkpoint / resume with ``torch.save``.

Counterpart of ``arcle_tpu/utils/checkpoint.py`` (an orbax manager): one
file per saved step, ``ckpt_<step>.pt``, the newest ``max_to_keep`` kept.
A checkpoint is a tree of tensors, numbers and dicts (policy and optimizer
``state_dict``s, the generator state, the iteration), loaded with
``weights_only=True``.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class Checkpointer:
    """``save(step, tree)`` / ``restore(step=None)`` in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        found = (_NAME.match(n) for n in os.listdir(self.dir))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        """Write atomically (a temporary file renamed into place), then
        drop the oldest checkpoints beyond ``max_to_keep``."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Optional[Any]:
        """The tree saved at ``step`` (default: the latest), or None when
        nothing was saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
