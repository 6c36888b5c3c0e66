"""Multi-process sharded stepping: one invocation per rank.

Counterpart of ``tests/multihost_worker.py``.  Every rank builds the same
global batch (32 O2ARCv2 envs on ``SyntheticLoader(6, seed=0)``,
``max_trial=3``, ``episode_limit=5``, a 4-deep reset pool), keeps its
block with :func:`~.multihost.shard_global_leading`, takes 10 steps of
bbox actions made with numpy from a seed (auto-resets from the pool
included), gathers the final state, the pool counters and every step's
rewards and flags (``step_reward`` ... ``[S, B]``), and prints ``CHECKSUM proc=<pid> nproc=<n>
value=<int>`` over them.  ``--state`` starts from a state, pool and
actions stored by another program (``.npz``: the ``EnvState`` fields, the
``ResetPool`` fields as ``pool_<name>``, ``selection`` ``[S, B, 30, 30]``
and ``operation`` ``[S, B]``); ``--out`` makes rank 0 store what it
gathered.

    python -m arcle_tpu_torch.parallel.rollout_worker <pid> <nproc> <port> \\
        [--device cuda|cpu] [--state in.npz] [--out out.npz]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

B, STEPS, POOL = 32, 10, 4


def make_env(device):
    from ..envs import BatchedEnv
    from ..loaders import SyntheticLoader
    from ..ops import o2arc_table
    return BatchedEnv(table=o2arc_table(max_trial=3),
                      bank=SyntheticLoader(6, seed=0).bank(device=device),
                      max_trial=3, episode_limit=5, auto_reset=True,
                      reset_pool=POOL)


def bbox_actions(seed: int = 1):
    """``STEPS`` steps of ``B`` random bbox selections and ops."""
    rng = np.random.default_rng(seed)
    sel = np.zeros((STEPS, B, 30, 30), np.int8)
    for s in range(STEPS):
        for b in range(B):
            x1, x2 = sorted(rng.integers(0, 30, 2))
            y1, y2 = sorted(rng.integers(0, 30, 2))
            sel[s, b, x1:x2 + 1, y1:y2 + 1] = 1
    return sel, rng.integers(0, 35, (STEPS, B)).astype(np.int32)


def _gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' blocks concatenated along the leading axis."""
    if dist.get_world_size() == 1:
        return x
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    return torch.cat(parts).to(x.dtype)


def run(device: str = "cuda", state: str = "", out: str = "") -> int:
    """Step this rank's block; returns the checksum of the gathered
    result."""
    from ..core.state import Action, FIELDS, state_from_numpy
    from ..envs.core import BatchedState, ResetPool
    from .mesh import make_mesh
    from .multihost import shard_global_leading

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    env = make_env(dev)
    if state:
        data = np.load(state)
        bs = BatchedState(
            env=state_from_numpy({k: data[k] for k in FIELDS}, dev),
            generator=torch.Generator(device=dev).manual_seed(0),
            pool=ResetPool(**{f.name: torch.from_numpy(
                data[f"pool_{f.name}"]).to(dev)
                for f in dataclasses.fields(ResetPool)}))
        sel, ops = data["selection"], data["operation"]
    else:
        bs = env.reset(torch.Generator(device=dev).manual_seed(0), B)
        sel, ops = bbox_actions()
    mesh = make_mesh(device_type=device)
    bs = shard_global_leading(bs, mesh, "data")
    rewards, terms, truncs = [], [], []
    for s in range(sel.shape[0]):
        a = shard_global_leading(Action(
            selection=torch.from_numpy(sel[s]).to(dev),
            operation=torch.from_numpy(ops[s]).to(dev)), mesh, "data")
        bs, _obs, rew, term, trunc = env.step(bs, a)
        rewards.append(rew)
        terms.append(term)
        truncs.append(trunc)
    result = {name: _gather(getattr(bs.env, name)) for name in FIELDS}
    result["pool_counter"] = _gather(bs.pool.counter)
    for name, rows in (("step_reward", rewards),
                       ("step_terminated", terms),
                       ("step_truncated", truncs)):
        result[name] = _gather(torch.stack(rows, dim=1)).T
    chk = (int(result["grid"].to(torch.int64).sum())
           + int(result["steps"].to(torch.int64).sum())
           + int(result["pool_counter"].to(torch.int64).sum())
           + int(result["step_reward"].sum())
           + int(result["step_terminated"].sum())
           + int(result["step_truncated"].sum()))
    if out and dist.get_rank() == 0:
        np.savez(out, **{k: v.cpu().numpy() for k, v in result.items()})
    return chk


def main(argv) -> None:
    from .multihost import init_multihost

    ap = argparse.ArgumentParser(
        prog="python -m arcle_tpu_torch.parallel.rollout_worker")
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--state", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    init_multihost(f"127.0.0.1:{args.port}", args.nproc, args.pid,
                   timeout_s=120.0, device=args.device)
    try:
        chk = run(args.device, args.state, args.out)
    finally:
        dist.destroy_process_group()
    print(f"CHECKSUM proc={args.pid} nproc={args.nproc} value={chk}",
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
