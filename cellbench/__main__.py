"""``python -m cellbench``: the same as ``python3 cellbench/run.py``."""

from cellbench.run import main

if __name__ == "__main__":
    raise SystemExit(main())
