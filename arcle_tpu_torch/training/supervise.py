"""Single-host training run supervisor: restart on hang or crash.

Counterpart of ``arcle_tpu/training/supervise.py``, standard library
only.  The reference gates training on Ray worker health
(emaml.py:352-354, ``healthy_worker_ids``); this is the single-host
counterpart of that gating:

* launches the training command as a subprocess in its own process group,
  teeing its output to a watched log file;
* declares the run dead when the log goes stale (no writes for
  ``--stale`` seconds; the trainers print a line per iteration) or the
  process exits non-zero;
* kills the whole process group and relaunches with ``--resume``
  appended, so the trainer restores its latest checkpoint
  (utils/checkpoint.py) and continues.

Usage::

    python -m arcle_tpu_torch.training.supervise --stale 900 \\
        --max-restarts 8 --log run.out -- \\
        python -m arcle_tpu_torch.training.train_gpt --iterations 100

Exit code is the final child's exit code (0 on a completed run).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def run_supervised(cmd, log_path: str, stale: float = 900.0,
                   max_restarts: int = 8, poll: float = 10.0) -> int:
    """Run ``cmd`` under staleness supervision; returns its exit code."""
    attempt = 0
    while True:
        argv = list(cmd)
        if attempt > 0 and "--resume" not in argv:
            argv.append("--resume")
        with open(log_path, "ab", buffering=0) as logf:
            logf.write(f"[supervise] attempt {attempt}: "
                       f"{' '.join(argv)}\n".encode())
            proc = subprocess.Popen(argv, stdout=logf, stderr=logf,
                                    start_new_session=True)
            hung = False
            while True:
                try:
                    rc = proc.wait(timeout=poll)
                    break
                except subprocess.TimeoutExpired:
                    age = time.time() - os.path.getmtime(log_path)
                    if age > stale:
                        logf.write(f"[supervise] log stale {age:.0f}s > "
                                   f"{stale:.0f}s; killing process group\n"
                                   .encode())
                        hung = True
                        # graceful first, then SIGKILL
                        try:
                            os.killpg(proc.pid, signal.SIGTERM)
                        except ProcessLookupError:
                            pass
                        try:
                            rc = proc.wait(timeout=20)
                        except subprocess.TimeoutExpired:
                            try:
                                os.killpg(proc.pid, signal.SIGKILL)
                            except ProcessLookupError:
                                pass
                            rc = proc.wait()
                        break
        if rc == 0 and not hung:
            return 0
        attempt += 1
        if attempt > max_restarts:
            print(f"[supervise] giving up after {max_restarts} restarts "
                  f"(last rc={rc})", file=sys.stderr)
            return rc if rc != 0 else 1
        print(f"[supervise] child {'hung' if hung else f'rc={rc}'}; "
              f"restarting with --resume (attempt {attempt})",
              file=sys.stderr)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n", 1)[0],
        usage="python -m arcle_tpu_torch.training.supervise [opts] -- "
              "cmd ...")
    ap.add_argument("--stale", type=float, default=900.0,
                    help="seconds of log silence before declaring a hang")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--log", required=True,
                    help="file the child's output is teed to and whose "
                         "mtime is the liveness heartbeat")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- followed by the training command")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (use -- python -m ... )")
    sys.exit(run_supervised(cmd, args.log, stale=args.stale,
                            max_restarts=args.max_restarts))


if __name__ == "__main__":
    main()
