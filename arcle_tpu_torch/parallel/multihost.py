"""Multi-process (multi-host) initialisation and liveness.

Counterpart of ``arcle_tpu/parallel/multihost.py``.  Every process calls
:func:`init_multihost` with the coordinator's address, the number of
processes and its own index; it then builds the same mesh over the whole
world (:func:`~.mesh.make_mesh`) and keeps its block of the env batch.
Stepping needs no collective; the learner's gradients are all-reduced
explicitly (:mod:`..training.ppo`).

Failure story: ``init_process_group`` waits for every process at most
``timeout_s`` (its own timeout, no watchdog thread), and a missing peer
raises :class:`MultihostInitTimeout`; between iterations
:func:`assert_all_processes_alive` runs a one-element all-reduce under a
timeout.  There is no elastic re-join: restart the whole job.
"""

from __future__ import annotations

import datetime
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import replicate, shard_leading

_RESTART = ("Restart the WHOLE job on all hosts (the ranks of a process "
            "group cannot re-join one by one) and resume from the latest "
            "checkpoint with --resume.")


class MultihostInitTimeout(RuntimeError):
    """A process failed to join the process group, or to answer the
    liveness all-reduce, within the timeout (the counterpart of RLlib's
    unhealthy-worker gating, reference emaml.py:352-354)."""


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout_s: float = 300.0, device: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` with failure detection.

    ``coordinator_address`` is ``"host:port"`` of process 0; ``None``
    reads ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    from the environment (as ``torchrun`` sets them).  ``device="cuda"``
    selects NCCL on card ``process_id % device_count``; ``"cpu"`` selects
    Gloo.  Nothing falls back from one to the other: NCCL without a card
    raises.  A peer that does not join within ``timeout_s`` raises
    :class:`MultihostInitTimeout`."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: device cuda, but CUDA is not "
                               "available (NCCL does not fall back to Gloo)")
        backend = "nccl"
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_multihost: device {device!r} (cuda or cpu)")
    init = "env://" if coordinator_address is None \
        else f"tcp://{coordinator_address}"
    try:
        dist.init_process_group(
            backend, init_method=init, world_size=num_processes,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    except dist.DistError as e:
        raise MultihostInitTimeout(
            f"distributed init did not complete within {timeout_s:.0f}s "
            f"(process_id={process_id}, num_processes={num_processes}, "
            f"coordinator={coordinator_address}): {e}. One or more "
            f"processes are missing or unreachable. {_RESTART}") from e


def assert_all_processes_alive(timeout_s: float = 60.0) -> None:
    """Liveness barrier: a one-element all-reduce that must complete, with
    the right sum, within ``timeout_s``; else :class:`MultihostInitTimeout`.
    Returns at once without a process group or at world size 1."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    x = torch.ones(1, device=dev)
    try:
        work = dist.all_reduce(x, async_op=True)
        done = work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise MultihostInitTimeout(
            f"liveness barrier failed within {timeout_s:.0f}s: {e}. A "
            f"process is unresponsive. {_RESTART}") from e
    if done is False or int(x.item()) != dist.get_world_size():
        raise MultihostInitTimeout(
            f"liveness barrier did not complete within {timeout_s:.0f}s "
            f"(sum {x.item()} of {dist.get_world_size()}). {_RESTART}")


def shard_global_leading(tree: Any, mesh: DeviceMesh,
                         axis: str = "data") -> Any:
    """This process's block of full values computed the same on every
    process (env states and task banks are cheap to build everywhere).
    A process holds only its own tensors, so this is
    :func:`~.mesh.shard_leading`; JAX needs a separate function to
    assemble one global array across hosts."""
    return shard_leading(tree, mesh, axis)


def replicate_global(tree: Any, mesh: DeviceMesh) -> Any:
    """Full values on every process, made equal to the first rank's: a
    broadcast (:func:`~.mesh.replicate`)."""
    return replicate(tree, mesh)
