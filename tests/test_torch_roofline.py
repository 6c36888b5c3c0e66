"""``arcle_tpu_torch.benchmarks.roofline`` against
``arcle_tpu.benchmarks.roofline``: ``summarize`` on the same inputs (the
port given the nominal ``"cpu"`` peaks, JAX on its CPU backend), the
peaks by card name, the step kernel's byte counts and the FLOP counter.

The port renames ``xla_flops_per_env_step`` to ``flops_per_env_step`` and
has no byte cost model, so it never emits ``xla_bytes_per_env_step`` /
``hbm_util_pct``; every share both emit is equal.
"""

import numpy as np
import pytest
import torch

from arcle_tpu.benchmarks import roofline as jax_roofline
from arcle_tpu_torch.benchmarks import color_table, roofline
from arcle_tpu_torch.envs import BatchedEnv
from arcle_tpu_torch.envs.rollout import (
    random_bbox_actions, random_point_actions)
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.models import FCPolicy
from arcle_tpu_torch.models.mlp import obs_width
from arcle_tpu_torch.ops import arc_table, o2arc_table, raw_table

RENAMED = {"xla_flops_per_env_step": "flops_per_env_step"}
NO_BYTE_MODEL = {"xla_bytes_per_env_step", "hbm_util_pct"}
RATE, BATCH, STEPS = 2_441_736.0, 4096, 100


@pytest.mark.parametrize("cost,analytic", [
    (None, None),
    ({"flops": 9.3e11, "bytes": 0.0}, None),
    ({"flops": 9.3e11, "bytes": 2.05e9}, None),
    ({"flops": 9.3e11, "bytes": 2.05e9}, 13559.0),
], ids=["no_cost", "flops", "flops_bytes", "analytic"])
def test_summarize_matches_jax(cost, analytic):
    want = jax_roofline.summarize(RATE, BATCH, STEPS, cost, analytic)
    peaks = roofline.device_peaks("cpu")
    got = roofline.summarize(RATE, BATCH, STEPS, cost, analytic, peaks,
                             mfu_peak="bf16")
    want = {RENAMED.get(k, k): v for k, v in want.items()}
    assert got["device_kind"] == want["device_kind"] == "cpu"
    assert got["power_limit_w"] is None
    assert set(want) - set(got) == NO_BYTE_MODEL & set(want)
    assert set(got) - set(want) <= {"power_limit_w", "mfu_peak"}
    for k in set(got) & set(want):
        assert got[k] == want[k], k
    if cost:
        assert got["mfu_peak"] == "bf16" and got["mfu_pct"] > 0
    if analytic:
        assert got["analytic_hbm_util_pct"] > 0


H100 = {"bf16_tflops": 989.0, "tf32_tflops": 495.0, "fp32_tflops": 67.0,
        "hbm_gbps": 3350.0}


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", H100),
    ("NVIDIA H100 SXM5 80GB, 500.00 W", H100),
    ("NVIDIA H100 PCIe, 350.00 W", {}),
    (None, {"bf16_tflops": 1.0, "hbm_gbps": 50.0}),
], ids=["h100_hbm3", "h100_sxm", "unknown", "cpu"])
def test_device_peaks_by_name(monkeypatch, line, want):
    if line is None:
        got = roofline.device_peaks("cpu")
        name, power = "cpu", None
    else:
        monkeypatch.setattr(roofline, "card_line", lambda index=0: line)
        got = roofline.device_peaks("cuda")
        name, power = line.split(",")[0], float(line.split()[-2])
    assert got == dict(want, name=name, power_limit_w=power)
    # an unknown card gets no peak, so no share at all
    out = roofline.summarize(RATE, BATCH, STEPS, {"flops": 1e12}, 1e4, got,
                             mfu_peak="bf16")
    assert ("mfu_pct" in out) == ("bf16_tflops" in want)
    assert ("analytic_hbm_util_pct" in out) == ("hbm_gbps" in want)
    assert out["flops_per_env_step"] > 0 and \
        out["analytic_bytes_per_env_step"] == 1e4


@pytest.mark.parametrize("table", [
    o2arc_table(max_trial=3), o2arc_table(max_trial=3, crop_at_33=True),
    arc_table(max_trial=3), raw_table(max_trial=3)],
    ids=["o2arc", "o2arc_crop33", "arc", "raw"])
def test_step_kernel_bytes_within_max(table):
    n, H, W = 64, 30, 30
    env = BatchedEnv(table=table,
                     bank=SyntheticLoader(8, seed=2).bank(device="cpu"),
                     max_trial=table.max_trial, auto_reset=True,
                     episode_limit=6, reset_pool=2)
    gen = torch.Generator().manual_seed(5)
    bs = env.reset(gen, n)
    most = roofline.step_kernel_bytes_max(table, H, W)
    least = 6 * H * W + roofline.SCALAR_BYTES
    seen = set()
    for t in range(12):
        draw = random_point_actions if t % 3 == 0 else random_bbox_actions
        act = draw(gen, n, table.n_ops, H, W, "cpu")
        nbytes = roofline.step_kernel_bytes(bs.env, act, table)
        assert n * least <= nbytes <= n * most
        seen.add(nbytes)
        bs = env.step(bs, act)[0]
    assert len(seen) > 1          # the count follows the data


@pytest.mark.parametrize("table,op,grids_in", [
    # Color: the grid, the selection, selected, object / object_sel /
    # background (copied through) and the clip
    (raw_table(max_trial=3), "Color3", 7),
    # ResetGrid overwrites the grid and reads no selection
    (arc_table(max_trial=3), "ResetGrid", 5),
    # Submit reads the answer and no selection
    (raw_table(max_trial=3), "Submit", 7),
], ids=["raw_color", "arc_reset", "raw_submit"])
def test_step_kernel_bytes_counts_one_op(table, op, grids_in):
    n, H, W = 16, 30, 30
    env = BatchedEnv(table=table,
                     bank=SyntheticLoader(8, seed=2).bank(device="cpu"),
                     max_trial=table.max_trial)
    gen = torch.Generator().manual_seed(1)
    st = env.reset(gen, n).env
    act = random_bbox_actions(gen, n, table.n_ops, H, W, "cpu")
    act = act.replace(operation=torch.full_like(
        act.operation, table.op_names().index(op)))
    assert roofline.step_kernel_bytes(st, act, table) == \
        n * ((grids_in + 6) * H * W + roofline.SCALAR_BYTES)


@pytest.mark.parametrize("table,H,W,want", [
    # in: 8 state grids + the selection, dims 6 x 2, flags 5, steps and
    # submit_count 2 x 4, the op 4; out: 6 grids, dims 4 x 2, flags 4,
    # steps / submit_count / last_action_op 3 x 4, reward 4, term and
    # pending 2
    (o2arc_table(), 30, 30, (9 * 900 + 12 + 5 + 8 + 4)
     + (6 * 900 + 8 + 4 + 12 + 4 + 2)),
    # a table with no Submit op never reads the answer
    (color_table(10), 5, 5, (8 * 25 + 12 + 5 + 8 + 4) + (6 * 25 + 8 + 4 + 12 + 4
                                                 + 2)),
], ids=["o2arc_30x30", "color_5x5"])
def test_step_kernel_bytes_max_counts_the_arguments(table, H, W, want):
    assert roofline.step_kernel_bytes_max(table, H, W) == want


def test_flop_counter_counts_a_policy_forward():
    B = 6
    pol = FCPolicy(hidden=(16, 8), n_ops=35,
                   generator=torch.Generator().manual_seed(0))
    obs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 10, (B, obs_width())).astype(np.float32))
    linears = [m for m in pol.modules() if isinstance(m, torch.nn.Linear)]
    want = 2 * B * sum(m.in_features * m.out_features for m in linears)
    with torch.no_grad():
        assert roofline.cost_from_flop_counter(pol, obs) == \
            {"flops": float(want)}
