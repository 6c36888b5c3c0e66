"""Dataset loaders -> task banks of tensors.

Counterpart of ``arcle_tpu/loaders/loader.py``.  A :class:`Loader` parses
ARC-format JSON (with the native baker of :mod:`..native` where it builds,
else ``json``) into per-task lists of numpy grids (the reference's
injectable seam); :class:`TaskBank` holds every pair of every task padded
into ``[P, H, W]`` int8 tensors with per-task offsets and counts, so a
reset gathers its task on the device.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

TaskTuple = Tuple[List[np.ndarray], List[np.ndarray],
                  List[np.ndarray], List[np.ndarray], Dict]


@dataclasses.dataclass(frozen=True)
class TaskBank:
    """All pairs of a dataset as tensors; train and test pairs share one
    flat pair axis, indexed per task by (offset, count)."""

    in_grids: torch.Tensor      # i8 [P, H, W]
    in_dims: torch.Tensor       # i8 [P, 2]
    out_grids: torch.Tensor     # i8 [P, H, W]
    out_dims: torch.Tensor      # i8 [P, 2]
    train_offset: torch.Tensor  # i32 [T]
    train_count: torch.Tensor   # i32 [T]
    test_offset: torch.Tensor   # i32 [T]
    test_count: torch.Tensor    # i32 [T]

    @property
    def n_tasks(self) -> int:
        return self.train_offset.shape[0]

    @property
    def n_pairs(self) -> int:
        return self.in_grids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.in_grids.device

    def to(self, device) -> "TaskBank":
        return TaskBank(**{f.name: getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)})

    def pair_index(self, prob: torch.Tensor, sub: torch.Tensor,
                   adaptation: torch.Tensor) -> torch.Tensor:
        """Flat pair index for (task, subproblem, train-vs-test), per env."""
        prob = prob.long()
        off = torch.where(adaptation, self.train_offset[prob],
                          self.test_offset[prob])
        return off + sub

    def pair_count(self, prob: torch.Tensor,
                   adaptation: torch.Tensor) -> torch.Tensor:
        prob = prob.long()
        return torch.where(adaptation, self.train_count[prob],
                           self.test_count[prob])


def bake_bank(tasks: Sequence[TaskTuple], H: int = 30, W: int = 30,
              device="cuda") -> TaskBank:
    """Pack parsed tasks into a :class:`TaskBank` on ``device`` (the card
    unless the caller asks for another device)."""
    in_g, in_d, out_g, out_d = [], [], [], []
    tr_off, tr_cnt, te_off, te_cnt = [], [], [], []

    def push(i, o):
        gi = np.zeros((H, W), np.int8)
        go = np.zeros((H, W), np.int8)
        gi[:i.shape[0], :i.shape[1]] = i
        go[:o.shape[0], :o.shape[1]] = o
        in_g.append(gi)
        in_d.append(np.array(i.shape, np.int8))
        out_g.append(go)
        out_d.append(np.array(o.shape, np.int8))

    for ti, to, ei, eo, _desc in tasks:
        tr_off.append(len(in_g))
        tr_cnt.append(len(ti))
        for i, o in zip(ti, to):
            push(i, o)
        te_off.append(len(in_g))
        te_cnt.append(len(ei))
        for i, o in zip(ei, eo):
            push(i, o)

    t = lambda a: torch.from_numpy(a).to(device)
    return TaskBank(
        in_grids=t(np.stack(in_g)), in_dims=t(np.stack(in_d)),
        out_grids=t(np.stack(out_g)), out_dims=t(np.stack(out_d)),
        train_offset=t(np.array(tr_off, np.int32)),
        train_count=t(np.array(tr_cnt, np.int32)),
        test_offset=t(np.array(te_off, np.int32)),
        test_count=t(np.array(te_cnt, np.int32)),
    )


class Loader(ABC):
    """Injectable dataset seam, API-compatible with the reference ABC."""

    def __init__(self, rng: Optional[np.random.Generator] = None, **kwargs):
        self.rng = rng
        self._pathlist = self.get_path(**kwargs)
        self.data: List[TaskTuple] = self.parse(**kwargs)

    @abstractmethod
    def get_path(self, **kwargs) -> List[str]:
        ...

    @abstractmethod
    def parse(self, **kwargs) -> List[TaskTuple]:
        ...

    def pick(self, data_index: Optional[int] = None, **kwargs) -> TaskTuple:
        """Host-side task sampling; an unseeded loader draws from its own
        Generator, not the global numpy RNG."""
        if not self.data:
            raise ValueError("dataset wasn't loaded properly")
        if data_index is None:
            rng = self.rng if self.rng is not None else np.random.default_rng()
            data_index = int(rng.integers(0, len(self.data)))
        if not 0 <= data_index < len(self.data):
            raise IndexError(f"task {data_index} out of {len(self.data)}")
        return self.data[data_index]

    def bank(self, H: int = 30, W: int = 30, device="cuda") -> TaskBank:
        return bake_bank(self.data, H, W, device)


def _parse_arc_json(text: str) -> TaskTuple:
    # the native C++ baker first (csrc/bake.cpp), json where it is missing
    # or refuses the text
    from ..native import bake_task_native
    baked = bake_task_native(text)
    if baked is not None:
        train, test = baked
        return ([i for i, _ in train], [o for _, o in train],
                [i for i, _ in test], [o for _, o in test], {})
    problem = json.loads(text)
    ti = [np.array(d["input"], np.int8) for d in problem["train"]]
    to = [np.array(d["output"], np.int8) for d in problem["train"]]
    ei = [np.array(d["input"], np.int8) for d in problem["test"]]
    eo = [np.array(d["output"], np.int8) for d in problem["test"]]
    return ti, to, ei, eo, {}


# The bundled sample datasets ship as data files of the JAX package; they
# are read as JSON, nothing of that package is imported.
_BUNDLED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "..", "arcle_tpu", "data")


class ARCLoader(Loader):
    """ARC-format directory loader: ``<root>/training/*.json`` or
    ``<root>/evaluation/*.json``; ``root`` defaults to ``$ARC_DATA_DIR`` or
    the bundled sample set."""

    def __init__(self, train: bool = True, root: Optional[str] = None):
        super().__init__(train=train, root=root)

    def get_path(self, **kwargs) -> List[str]:
        root = kwargs.get("root") or os.environ.get("ARC_DATA_DIR") \
            or os.path.join(_BUNDLED, "sample_arc")
        sub = "training" if kwargs.get("train", True) else "evaluation"
        return sorted(glob.glob(os.path.join(root, sub, "*.json")))

    def parse(self, **kwargs) -> List[TaskTuple]:
        out = []
        for p in self._pathlist:
            with open(p) as fp:
                task = _parse_arc_json(fp.read())
            task[-1]["id"] = os.path.basename(p).split(".")[0]
            out.append(task)
        return out


class MiniARCLoader(Loader):
    """Mini-ARC loader, with the reference's ``null -> "0"`` raw-text
    replacement and its description-from-filename convention."""

    def __init__(self, root: Optional[str] = None):
        super().__init__(root=root)

    def get_path(self, **kwargs) -> List[str]:
        root = kwargs.get("root") or os.environ.get("MINIARC_DATA_DIR") \
            or os.path.join(_BUNDLED, "sample_miniarc")
        paths = glob.glob(os.path.join(root, "*.json"))
        paths.sort(key=lambda fn: fn.split("_")[-1])
        return paths

    def parse(self, **kwargs) -> List[TaskTuple]:
        out = []
        for p in self._pathlist:
            with open(p) as fp:
                task = _parse_arc_json(fp.read().replace("null", '"0"'))
            fns = os.path.basename(p).split("_")
            task[-1]["id"] = fns[-1].split(".")[-2]
            task[-1]["description"] = " ".join(fns[0:-1]).strip()
            out.append(task)
        return out


class ListLoader(Loader):
    """Wrap in-memory task tuples (the injectable test seam)."""

    def __init__(self, tasks: Sequence[TaskTuple]):
        self._tasks = list(tasks)
        super().__init__()

    def get_path(self, **kwargs):
        return ["<memory>"] * len(self._tasks)

    def parse(self, **kwargs):
        return self._tasks
