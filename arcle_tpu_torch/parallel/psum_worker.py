"""Isolated all-reduce timing worker (one process per rank) for the
all-reduce cost-model check of :func:`.scaling.validate_allreduce_model`.

Counterpart of ``arcle_tpu/parallel/psum_worker.py``.  Every rank joins a
Gloo group on ``127.0.0.1:<port>``, so the all-reduce crosses the process
boundary through the host's TCP channel.  For each payload size (in MB) it
all-reduces a float32 buffer holding ``rank + 1`` once to warm up, then
five times; the time is the least of the five, and every element must
equal the sum of ``rank + 1`` over the ranks.  Rank 0 prints one line,
``PSUM_TIMES {"<size>": seconds, ...}`` with the sizes as given.

    python -m arcle_tpu_torch.parallel.psum_worker <pid> <nproc> <port> \\
        <comma-separated payload sizes in MB>
"""

import json
import sys
import time

import torch
import torch.distributed as dist

from .multihost import init_multihost


def main(argv) -> None:
    pid, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    size_tokens = argv[3].split(",")     # echoed back verbatim as keys
    init_multihost(f"127.0.0.1:{port}", nproc, pid, timeout_s=120.0,
                   device="cpu")
    try:
        expect = float(nproc * (nproc + 1) // 2)
        results = {}
        for tok in size_tokens:
            n = int(float(tok) * 1e6 / 4)
            local = torch.full((n,), float(pid + 1))
            buf = local.clone()
            dist.all_reduce(buf)                              # warm-up
            best = float("inf")
            for _ in range(5):
                buf.copy_(local)
                t0 = time.perf_counter()
                dist.all_reduce(buf)
                best = min(best, time.perf_counter() - t0)
            if not bool((buf == expect).all()):
                raise AssertionError(f"all-reduce of {tok} MB: elements "
                                     f"other than {expect}")
            results[tok] = best
        if pid == 0:
            print("PSUM_TIMES " + json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
