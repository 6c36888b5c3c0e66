"""The gym adapter on the card (the CUDA step kernel at B=1) against the
native C++ engine.  It skips without a card; on one, run it with
``python -m pytest tests/test_torch_gym_gpu.py -m gpu``.  This file
imports no JAX, so it also runs where JAX is not installed."""

import numpy as np
import pytest
import torch

from arcle_tpu_torch.envs import CustomO2ARCEnv, O2ARCv2Env
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.ops import step_kernel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step kernel has no CPU mode")
    return torch.device("cuda", 0)


def random_action(rng, t, side=30):
    sel = np.zeros((side, side), np.int8)
    if t % 3 == 1:
        sel[rng.integers(0, side), rng.integers(0, side)] = 1
    elif t % 3 == 2:
        x1, x2 = sorted(rng.integers(0, side, 2).tolist())
        y1, y2 = sorted(rng.integers(0, side, 2).tolist())
        sel[x1:x2 + 1, y1:y2 + 1] = 1
    return {"selection": sel, "operation": int(rng.integers(0, 35))}


def assert_obs_equal(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        if k == "object_states":
            assert_obs_equal(got[k], v, what)
            continue
        assert got[k].dtype == v.dtype, (what, k)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what} {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("cls", [O2ARCv2Env, CustomO2ARCEnv])
def test_cuda_adapter_matches_native(cuda_device, cls):
    """60 steps, one kernel launch per step, obs / reward / terminated
    bit-exact."""
    rng = np.random.default_rng(42)
    envs = [cls(data_loader=SyntheticLoader(3, seed=9), backend=b,
                device=cuda_device) for b in ("native", "torch")]
    for e in envs:
        if cls is CustomO2ARCEnv:
            e.set_task(1)
        e.reset(seed=0, options={"prob_index": 1, "subprob_index": 0})
    launches = step_kernel.LAUNCHES
    for t in range(60):
        act = random_action(rng, t)
        (o_n, r_n, t_n, _, _), (o_t, r_t, t_t, _, _) = \
            [e.step(act) for e in envs]
        assert (r_n, t_n) == (r_t, t_t), t
        assert_obs_equal(o_t, o_n, f"step {t}")
    assert step_kernel.LAUNCHES - launches == 60
