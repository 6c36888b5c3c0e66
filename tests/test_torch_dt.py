"""The port's Decision-Transformer policy and its behaviour cloning
(``arcle_tpu_torch.models.dt``, ``arcle_tpu_torch.training.dt_bc``)
against ``arcle_tpu``'s.

Both packages read the same golden traces (``generate_golden_traces(
n_traces=8, seed=11, n_steps=10)``, the JAX package's own BC test input);
the weights cross over through ``models.convert.dt_state_dict_from_flax``.
The batch is bit-identical; the float32 forward within 1e-5 of each
output's largest magnitude, the BC loss within 1e-5 relative, and five
full-batch Adam steps within 1e-4 relative (XLA and PyTorch sum in other
orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.models.dt import DTConfig as JDTConfig
from arcle_tpu.models.dt import DTPolicy as JDTPolicy
from arcle_tpu.training import dt_bc as jdt_bc
from arcle_tpu.validation import generate_golden_traces as j_traces

from arcle_tpu_torch.models import DTConfig, DTPolicy, dt_state_dict_from_flax
from arcle_tpu_torch.training import dt_bc
from arcle_tpu_torch.validation import generate_golden_traces

SIZES = dict(n_layer=2, n_head=2, n_embd=32, max_timesteps=10)
T_MAX = 10


@functools.lru_cache(maxsize=None)
def traces():
    return j_traces(n_traces=8, seed=11, n_steps=10)


@functools.lru_cache(maxsize=None)
def batches():
    tasks, tr, infos = traces()
    return (jdt_bc.dataset_from_traces(tasks, tr, infos, T_max=T_MAX),
            dt_bc.dataset_from_traces(tasks, tr, infos, T_max=T_MAX,
                                      device="cpu"))


def carried(seed: int):
    """JAX's initial params for ``SIZES`` and the port's policy holding
    them."""
    jb, _ = batches()
    jmodel = JDTPolicy(JDTConfig(**SIZES))
    params = jmodel.init(jax.random.key(seed), jb.grids, jb.rtg, jb.actions,
                         jb.timesteps)
    state = dt_state_dict_from_flax(jax.tree.map(np.asarray, params))
    model = DTPolicy(DTConfig(**SIZES))
    model.load_state_dict(state)
    return jmodel, params, model, state


@pytest.mark.parametrize("t_max", [T_MAX, 25])
def test_dataset_matches(t_max):
    """The port's traces equal JAX's, and both datasets are bit-identical
    with the JAX package's dtypes, truncated (10) and padded (25)."""
    tasks, tr, infos = traces()
    ptasks, ptr, pinfos = generate_golden_traces(n_traces=8, seed=11,
                                                 n_steps=10)
    assert pinfos == infos
    for a, b in zip(ptr, tr):
        assert [e[1:3] for e in a] == [e[1:3] for e in b]
        for ea, eb in zip(a, b):
            np.testing.assert_array_equal(ea[3], eb[3])
    jb = jdt_bc.dataset_from_traces(tasks, tr, infos, T_max=t_max)
    tb = dt_bc.dataset_from_traces(tasks, tr, infos, T_max=t_max,
                                   device="cpu")
    for name, j, t in zip(jb._fields, jb, tb):
        assert np.asarray(j).dtype == t.numpy().dtype, name
        np.testing.assert_array_equal(np.asarray(j), t.numpy(),
                                      err_msg=name)
    assert tb.grids.shape[1] == t_max and float(tb.mask.sum()) > 0


def test_forward_and_loss_match():
    jmodel, params, model, _ = carried(0)
    jb, tb = batches()
    jout = jmodel.apply(params, jb.grids, jb.rtg, jb.actions, jb.timesteps)
    with torch.no_grad():
        tout = model(tb.grids, tb.rtg, tb.actions, tb.timesteps)
        tloss = dt_bc.bc_loss(model, tb)
    assert set(tout) == set(jout)
    for k in jout:
        want = np.asarray(jout[k])
        assert tout[k].shape == want.shape, k
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(tout[k].numpy() - want).max())
        assert err <= 1e-5 * scale, (k, err, scale)
    jloss = float(jdt_bc.bc_loss(params, jmodel, jb))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)


def test_train_bc_matches():
    """Five full-batch Adam steps from the same initial params: the losses
    before each update agree."""
    jmodel, _, _, state = carried(3)
    jb, tb = batches()
    _, jlosses = jdt_bc.train_bc(jmodel, jb, jax.random.key(3), n_steps=5,
                                 lr=1e-3)
    _, tlosses = dt_bc.train_bc(DTPolicy(DTConfig(**SIZES)), tb, n_steps=5,
                                lr=1e-3, params=state, device="cpu")
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)


def test_dt_behavior_cloning_learns():
    """The port's counterpart of ``tests/test_training.py::
    test_dt_behavior_cloning_learns``, same sizes and threshold."""
    tasks, tr, infos = generate_golden_traces(n_traces=8, seed=11,
                                              n_steps=10)
    batch = dt_bc.dataset_from_traces(tasks, tr, infos, T_max=10,
                                      device="cpu")
    assert batch.grids.shape[1] == 10
    assert float(batch.mask.sum()) > 0
    model = DTPolicy(DTConfig(n_layer=1, n_head=2, n_embd=32,
                              max_timesteps=10))
    _, losses = dt_bc.train_bc(model, batch, torch.Generator().manual_seed(0),
                               n_steps=30, lr=1e-3, device="cpu")
    assert torch.isfinite(losses).all()
    assert float(losses[-1]) < float(losses[0]) * 0.9


def test_dt_entry_points_default_to_the_card():
    import inspect
    for fn in (dt_bc.dataset_from_traces, dt_bc.train_bc):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
