"""Readings that set the limits of ``correct``: the numbers each run
compares, on many seeds, for the port (``sound``), for the reference put
in the port's place at the precision below the configuration's
(``control``), and for a planted fault (``half_batch``: every update's
loss over half of its rows).  No measured window: set-up and the units
the checks read, then the comparisons.  One JSON line per seed and
variant on standard output.

    python3 cellbench/calibrate.py --workload o2arc_mlp.ppo --seeds 1,2,3 \\
        --variants sound,control,half_batch
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    _here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _here]
    sys.path.insert(0, str(_here.parent))

from cellbench import harness as H  # noqa: E402

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def control_ppo(cell, ref, prec, fault):
    return cell.compare(cell.reference(prec=prec, fault=fault), ref,
                        detail=True)


def sound_ppo(cell, ref):
    return cell.compare({"setup": cell.rec, "window": cell.win}, ref,
                        detail=True)


def first_gradient(cell, prec="fp32", fault="none"):
    """The reference's first optimizer step's gradient, from a replay of
    the first checked iteration alone."""
    from cellbench.reference.ppo import follow
    cfg = cell.spec["config"]
    rec = dict(cell.rec, iters=cell.rec["iters"][:1])
    return follow(rec, cell.weights, cell.K.policy_ref(cfg),
                  cell.K.env_spec(cfg), cell.L, cell.L["entropy_coeff"],
                  cell.K.bank(cfg, cell.seed), cell.digest_w, prec=prec,
                  fault=fault)["first_grads"]


def control_engine(cell):
    import torch
    ref = cell.reference()
    low = cell.reference(reward_dtype=torch.bfloat16)
    rows = 0
    for s, r in ref["segments"].items():
        c = low["segments"][s]
        for k in ("rewards", "term", "trunc"):
            rows += int((c[k] != r[k]).sum())
    return {"transitions": float(rows)}


def control_eval(cell, prec):
    """The lower precision's greedy choice at each position of the same
    episodes, read as a gap under the reference; its log-prob of each
    sampled action against the reference's."""
    import torch
    policy = cell.K.policy_ref(cell.spec["config"])
    ref = cell.reference()
    low = cell.reference(prec=prec)
    argmax_gap = 0.0
    for i, rec in cell.batches.items():
        if not rec["det"]:
            continue
        st = rec["start"]
        from cellbench.reference import engine as E
        spec = cell.K.env_spec(cell.spec["config"],
                               episode_limit=cell.steps)
        for t, acts in enumerate(rec["acts"]):
            obs = policy.observe(st)
            with torch.no_grad():
                out = policy.forward(cell.weights, obs, prec)
                op = out["op_logits"].argmax(-1)
                bl = out["bbox_logits"][torch.arange(op.shape[0],
                                                     device=op.device), op]
                greedy = torch.cat([bl.argmax(-1), op[:, None]], 1)
                lop, lbb, _ = policy.dists(cell.weights, obs, greedy,
                                           "fp32")
            gap = torch.maximum(
                lop.max(-1).values - lop.gather(-1, op[:, None])[:, 0],
                (lbb.max(-1).values - lbb.gather(
                    -1, greedy[:, :4, None])[..., 0]).max(-1).values)
            argmax_gap = max(argmax_gap, float(gap.max()))
            st = E.env_step(spec, st, E.bbox_actions(acts, cell.size,
                                                     cell.size))[0]
    nums = cell.compare(lambda i, t: low[i]["lp"][t], ref)
    nums["argmax_gap"] = argmax_gap
    return nums


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="python3 cellbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="sound")
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="only the first N seeds read the variants other "
                         "than sound")
    ap.add_argument("--first-gradient", action="store_true",
                    help="a PPO cell's first gradient's numbers alone, "
                         "from a replay of its first iteration")
    args = ap.parse_args(argv)
    H.set_cache_dirs()
    spec = H.load_cell(args.workload)
    import torch
    if device == "cuda":
        H.require_cards(int(spec["cell"]["chips"]))
    from cellbench.reference.numerics import full_float32
    full_float32()
    dev = torch.device(device)
    drv = H.driver(spec["traffic"]["driver"])
    prec = CONTROL[spec["config"]["precision"]["compute"]]
    variants = args.variants.split(",")
    for n_seed, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = drv.setup(spec, seed, dev, H.Spans(False))
        checked = getattr(cell, "checked", ())
        units = max(checked) + 1 if checked and not args.first_gradient \
            else 0
        for i in range(units):
            cell.unit(i)
        cell.after_window()
        cell.release()
        ref = None           # the float32 reference of a PPO cell, once
        for v in variants:
            if v != "sound" and args.control_seeds is not None \
                    and n_seed >= args.control_seeds:
                continue
            t1 = time.perf_counter()
            kind = spec["traffic"]["driver"]
            if args.first_gradient:
                from cellbench.reference.compare import grad_numbers
                ref = ref if ref is not None else first_gradient(cell)
                cand = (cell.rec["first_grads"] if v == "sound"
                        else first_gradient(cell, prec) if v == "control"
                        else first_gradient(cell, fault=v))
                nums = grad_numbers(cand, ref)
            elif v == "sound":
                if kind == "ppo":
                    ref = ref if ref is not None else cell.reference()
                    nums = sound_ppo(cell, ref)
                else:
                    nums = cell.check()
            elif v == "control":
                if kind == "ppo":
                    ref = ref if ref is not None else cell.reference()
                    nums = control_ppo(cell, ref, prec, "none")
                else:
                    nums = (control_engine(cell) if kind == "random_act"
                            else control_eval(cell, prec))
            elif v == "half_batch":
                ref = ref if ref is not None else cell.reference()
                nums = control_ppo(cell, ref, "fp32", "half_batch")
            else:
                raise SystemExit(f"variant {v!r}")
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": v, "numbers": nums,
                              "seconds": time.perf_counter() - t1,
                              "units": units,
                              "setup_and_units_s": t1 - t0}), flush=True)
        del cell
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
