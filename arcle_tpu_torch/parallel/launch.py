"""Start and reap the ranks of a multi-process run on one host.

:func:`spawn` runs a function in ``n`` fresh processes.  Rank ``r`` calls
:func:`~.multihost.init_multihost` on ``127.0.0.1`` (NCCL for
``device="cuda"``, Gloo for ``"cpu"``), then ``function(*args)`` with the
arguments as strings, and destroys its process group when the function
returns.  :func:`run_commands` is the process management underneath: the
processes write to files (a full pipe cannot stall a rank), every process
is killed when one fails or the deadline passes, and a failure raises with
the failing ranks' exit codes and the end of their error output.

    python -m arcle_tpu_torch.parallel.launch <module:function | file.py:function> \\
        <rank> <n> <port> <cpu|cuda> [arguments...]
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]
FAILED_GRACE_S = 10.0     # how long the other ranks may take to exit after
                          # one has failed, before they are killed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """The environment of a rank: this one, with the repository on the
    import path."""
    env = dict(os.environ)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + paths)
    return env


def run_commands(cmds: Sequence[Sequence[str]], timeout_s: float
                 ) -> List[str]:
    """Run ``cmds`` concurrently from the repository's root and return
    their standard outputs.  Raises ``RuntimeError`` if one exits
    non-zero and ``TimeoutError`` after ``timeout_s``; either way no
    process is left running."""
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"{i}.out" for i in range(len(cmds))]
        errs = [Path(tmp) / f"{i}.err" for i in range(len(cmds))]
        procs: List[subprocess.Popen] = []
        deadline = time.monotonic() + timeout_s
        failed_at: Optional[float] = None
        try:
            for cmd, out, err in zip(cmds, outs, errs):
                with open(out, "w") as fo, open(err, "w") as fe:
                    procs.append(subprocess.Popen(
                        list(cmd), stdout=fo, stderr=fe, env=rank_env(),
                        cwd=REPO))
            while True:
                codes = [p.poll() for p in procs]
                now = time.monotonic()
                if all(c is not None for c in codes):
                    break
                if failed_at is None and any(c for c in codes):
                    failed_at = now
                if failed_at is not None and now - failed_at > FAILED_GRACE_S:
                    break
                if now > deadline:
                    raise TimeoutError(
                        f"{len(cmds)} processes did not finish within "
                        f"{timeout_s:.0f} s: {list(cmds[0])}")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        stdout = [o.read_text() for o in outs]
        bad = [(i, p.returncode, errs[i].read_text()[-3000:])
               for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("; ".join(
            f"process {i} of {list(cmds[i])} exited {code}:\n{err}"
            for i, code, err in bad))
    return stdout


def spawn(target: str, n: int, device: str = "cuda",
          args: Sequence[object] = (), timeout_s: float = 600.0
          ) -> List[str]:
    """Run ``target`` (``"package.module:function"`` or
    ``"path/to/file.py:function"``) on ``n`` ranks of one host; returns
    each rank's standard output."""
    port = free_port()
    return run_commands(
        [[sys.executable, "-m", "arcle_tpu_torch.parallel.launch", target,
          str(r), str(n), str(port), device, *map(str, args)]
         for r in range(n)], timeout_s)


def resolve(target: str) -> Callable:
    where, name = target.rsplit(":", 1)
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(where).stem,
                                                      where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def main(argv: Sequence[str]) -> None:
    import torch
    import torch.distributed as dist

    from .multihost import init_multihost

    target, rank, n, port, device, *args = argv
    rank, n = int(rank), int(n)
    if device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    fn = resolve(target)
    init_multihost(f"127.0.0.1:{port}", n, rank, timeout_s=120.0,
                   device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
