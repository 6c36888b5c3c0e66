"""``arcle_tpu_torch`` augmentation, observation flattening and the MLP
policy against ``arcle_tpu``.

The same inputs, made from a seed with numpy, go through both packages;
weights cross over through ``arcle_tpu_torch.models.convert``.  Integer
results (augmented grids, flattened observations, sampled actions) are
bit-exact; float results carry the tolerance stated at each test, because
XLA and PyTorch sum matrix products in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.core.state import EnvState as JEnvState
from arcle_tpu.envs.meta import augment_task as j_augment_task
from arcle_tpu.models.mlp import FCPolicy as JFCPolicy
from arcle_tpu.models.mlp import HyperMLP as JHyperMLP
from arcle_tpu.models import mlp as jmlp
from arcle_tpu import wrappers as jwrap

from arcle_tpu_torch.core import FIELDS, state_from_numpy
from arcle_tpu_torch.envs.meta import augment_task, draw_augmentation
from arcle_tpu_torch.models import (
    FCPolicy, HyperMLP, fcpolicy_state_dict_from_flax,
    hypermlp_state_dict_from_flax, multi_categorical_sample,
    multi_categorical_log_prob, multi_categorical_entropy,
)
from arcle_tpu_torch import wrappers

SIZES = (30, 30, 30, 30, 35)


def padded_pairs(rng, batch):
    """Random colour grids padded with zeros outside random, mostly
    non-square dims."""
    def grids():
        dims = rng.integers(1, 31, (batch, 2)).astype(np.int8)
        g = rng.integers(0, 10, (batch, 30, 30)).astype(np.int8)
        rows = np.arange(30)[None, :, None]
        cols = np.arange(30)[None, None, :]
        inside = (rows < dims[:, :1, None]) & (cols < dims[:, 1:, None])
        return np.where(inside, g, 0).astype(np.int8), dims
    return grids() + grids()


def test_augment_task_matches():
    """Bit-exact against ``arcle_tpu.envs.meta.augment_task``, fed the k
    and perm that JAX draws from each key; all four k, non-square dims."""
    B = 96
    grid, dim, answer, answer_dim = padded_pairs(np.random.default_rng(0), B)
    assert (dim[:, 0] != dim[:, 1]).sum() > B // 2
    keys = jax.random.split(jax.random.key(0), B)
    jout = jax.vmap(j_augment_task)(keys, jnp.asarray(grid),
                                    jnp.asarray(dim), jnp.asarray(answer),
                                    jnp.asarray(answer_dim))

    def draw(key):
        kk, kp = jax.random.split(key)
        return (jax.random.randint(kk, (), 0, 4),
                jax.random.permutation(kp, jnp.arange(10, dtype=jnp.int8)))
    k, perm = jax.vmap(draw)(keys)
    assert set(np.asarray(k).tolist()) == {0, 1, 2, 3}
    tout = augment_task(*(torch.from_numpy(a) for a in
                          (grid, dim, answer, answer_dim)),
                        torch.tensor(np.asarray(k)),
                        torch.tensor(np.asarray(perm)))
    for name, j, t in zip(("grid", "dim", "answer", "answer_dim"), jout,
                          tout):
        assert t.dtype == torch.int8, name
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)


def test_draw_augmentation():
    """k covers [0, 4) and every row of perm is a permutation of the ten
    colours."""
    k, perm = draw_augmentation(torch.Generator().manual_seed(0), 256, "cpu")
    assert set(k.tolist()) == {0, 1, 2, 3}
    assert perm.dtype == torch.int8
    assert (perm.sort(dim=1).values == torch.arange(10)).all()
    assert len({tuple(r) for r in perm.tolist()}) > 200


def random_state(rng, batch=6):
    """Every field of a batched state filled with random values of its
    dtype (int8 over its whole range)."""
    shapes = {"grid": (30, 30), "input": (30, 30), "clip": (30, 30),
              "selected": (30, 30), "object": (30, 30),
              "object_sel": (30, 30), "background": (30, 30),
              "answer": (30, 30), "grid_dim": (2,), "input_dim": (2,),
              "clip_dim": (2,), "object_dim": (2,), "object_pos": (2,),
              "answer_dim": (2,)}
    out = {}
    for name in FIELDS:
        shape = (batch,) + shapes.get(name, ())
        if name == "last_reward":
            out[name] = rng.standard_normal(shape).astype(np.float32)
        elif name in ("steps", "submit_count", "last_action_op"):
            out[name] = rng.integers(-1, 200, shape).astype(np.int32)
        else:
            out[name] = rng.integers(-128, 128, shape).astype(np.int8)
    return out


def test_flatten_obs_matches():
    """``flatten_obs`` (2710 wide), ``full_flatten_obs`` (6314 wide) and
    ``unflatten_full``: bit-exact."""
    arrays = random_state(np.random.default_rng(1))
    jst = JEnvState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = state_from_numpy(arrays)
    for jfn, tfn, width in ((jwrap.flatten_obs, wrappers.flatten_obs, 2710),
                            (jwrap.full_flatten_obs,
                             wrappers.full_flatten_obs,
                             wrappers.FULL_OBS_DIM)):
        j, t = np.asarray(jfn(jst)), tfn(tst)
        assert t.shape == (6, width) and t.dtype == torch.int8
        np.testing.assert_array_equal(j, t.numpy())
    assert wrappers.FULL_OBS_DIM == 6314
    full = wrappers.full_flatten_obs(tst)
    jun = jwrap.unflatten_full(jnp.asarray(full.numpy()))
    tun = wrappers.unflatten_full(full)
    assert set(jun) == set(tun)
    for k in jun:
        assert tun[k].dtype == torch.int32, k
        np.testing.assert_array_equal(np.asarray(jun[k]), tun[k].numpy(),
                                      err_msg=k)
    filt = wrappers.filter_obs(tst)
    assert tuple(filt) == wrappers.FILTER_O2ARC_KEYS


def carried_policy(hidden=(32, 32), seed=0):
    """A flax FCPolicy, its params, and the port's policy with those
    weights."""
    jpol = JFCPolicy(hidden=hidden, n_ops=35)
    params = jpol.init(jax.random.key(seed), jnp.zeros((1, 2710), jnp.int8))
    tpol = FCPolicy(hidden=hidden, n_ops=35)
    tpol.load_state_dict(fcpolicy_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    return jpol, params, tpol


def random_obs(rng, n):
    """Flattened observations in the ranges the engine produces, in the
    sorted key order: active, clip, clip_dim, grid, grid_dim, object,
    object_dim, object_pos, trials_remain (up to 127)."""
    parts = [rng.integers(0, 2, (n, 1)), rng.integers(0, 10, (n, 900)),
             rng.integers(0, 31, (n, 2)), rng.integers(0, 10, (n, 900)),
             rng.integers(1, 31, (n, 2)), rng.integers(0, 10, (n, 900)),
             rng.integers(0, 31, (n, 2)), rng.integers(-30, 31, (n, 2)),
             rng.integers(0, 128, (n, 1))]
    return np.concatenate(parts, axis=1).astype(np.int8)


def test_fcpolicy_forward_matches():
    """Logits and value with the flax weights carried across:
    rtol 1e-5, atol 1e-6."""
    jpol, params, tpol = carried_policy()
    obs = random_obs(np.random.default_rng(2), 64)
    jl, jv = jpol.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = tpol(torch.from_numpy(obs))
    assert [t.shape[-1] for t in tl] == list(SIZES)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def test_fcpolicy_init_matches_flax_distribution():
    """The port draws its weights from flax's distributions: truncated
    lecun-normal torso, orthogonal heads (gain 0.01 / 1.0), zero biases;
    a seeded CPU generator gives the same weights every time."""
    hidden = (256, 128)
    _, params, _ = carried_policy(hidden)
    p = jax.tree.map(np.asarray, params)["params"]
    pol = FCPolicy(hidden=hidden, generator=torch.Generator().manual_seed(0))
    for i, fan_in in enumerate((2710, 256)):
        w = getattr(pol, f"fc_{i}").weight.detach().numpy()
        std = np.sqrt(1.0 / fan_in)
        assert abs(w.std() / std - 1) < 0.05
        assert abs(p[f"fc_{i}"]["kernel"].std() / std - 1) < 0.05
        assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-7
    # 155 outputs from 128 inputs: the columns are orthogonal, of norm 0.01
    pi = pol.pi.weight.detach().numpy().astype(np.float64)
    np.testing.assert_allclose(pi.T @ pi, 1e-4 * np.eye(128), atol=1e-9)
    np.testing.assert_allclose(np.linalg.norm(pol.vf.weight.detach()), 1.0,
                               rtol=1e-5)
    assert all(float(getattr(pol, n).bias.detach().abs().max()) == 0.0
               for n in ("fc_0", "fc_1", "pi", "vf"))
    again = FCPolicy(hidden=hidden,
                     generator=torch.Generator().manual_seed(0))
    for a, b in zip(pol.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hidden", [(32, 32), (256, 128, 64)],
                         ids=["narrow", "wide"])
def test_fcpolicy_bf16_matches(hidden):
    """The bf16 torso (float32 parameters and ``pi`` / ``vf`` heads, as
    flax's ``Dense(dtype=bfloat16)``) with the flax weights carried across,
    against JAX's bf16 policy: every output within 1e-3 of its largest
    magnitude (measured ~2e-4: both round each layer's float32
    accumulation to bf16 once).  Against the float32 path: within 0.03 of
    the float32 output's largest magnitude (measured 0.01: bf16 keeps 8
    bits).  The outputs are float32."""
    jbf = JFCPolicy(hidden=hidden, n_ops=35, dtype=jnp.bfloat16)
    j32 = JFCPolicy(hidden=hidden, n_ops=35)
    params = jbf.init(jax.random.key(0), jnp.zeros((1, 2710), jnp.int8))
    tbf = FCPolicy(hidden=hidden, n_ops=35, dtype=torch.bfloat16)
    tbf.load_state_dict(fcpolicy_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    assert all(p.dtype == torch.float32 for p in tbf.parameters())
    obs = random_obs(np.random.default_rng(2), 64)
    jl, jv = jbf.apply(params, jnp.asarray(obs))
    fl, fv = j32.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = tbf(torch.from_numpy(obs))
    assert tv.dtype == torch.float32 and tl[0].dtype == torch.float32
    differs = False
    for t, j, f in zip(tl + (tv,), jl + (jv,), fl + (fv,)):
        t, j, f = t.numpy(), np.asarray(j), np.asarray(f)
        scale = np.abs(f).max()
        assert np.abs(t - j).max() <= 1e-3 * scale
        assert np.abs(t - f).max() <= 0.03 * scale
        differs |= bool(np.abs(t - f).max() > 1e-4 * scale)
    assert differs                      # the torso did run in bf16


def test_hypermlp_matches():
    """``HyperMLP`` (a stack of ``WLinear``) with the flax weights carried
    across by ``hypermlp_state_dict_from_flax``: rtol 1e-5, atol 1e-6; the
    generated weight is ``theta[:in * out]`` as ``[in, out]``; and the
    port's own draw has flax's statistics (``z`` ~ N(0, 1/out), ``fc``
    lecun-normal, zero bias; std within 10%)."""
    jm = JHyperMLP(widths=(32, 16), out=4)
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    y = jm.apply(params, jnp.asarray(x))
    tm = HyperMLP(8, (32, 16), 4)
    sd = hypermlp_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    with torch.no_grad():
        ty = tm(torch.from_numpy(x))
        theta = tm.wl_0.fc(tm.wl_0.z)
        h = torch.tanh(torch.from_numpy(x) @ theta[:256].reshape(8, 32)
                       + theta[256:])
    assert ty.shape == (3, 4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(torch.tanh(tm.wl_0(torch.from_numpy(x)))
                               .detach().numpy(), h.numpy(), rtol=1e-6)
    own = HyperMLP(8, (32, 16), 4,
                   generator=torch.Generator().manual_seed(0)).state_dict()
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
        if k.endswith("bias"):
            assert float(own[k].abs().max()) == 0.0
        else:
            assert abs(float(own[k].std() / v.std()) - 1) < 0.1, k
    assert abs(float(own["wl_out.z"].std()) * 4 - 1) < 0.1


def random_logits(rng, n):
    return tuple(rng.standard_normal((n, s)).astype(np.float32) * 2
                 for s in SIZES)


def test_multi_categorical_sample_matches():
    """JAX's uniforms injected: actions bit-exact, log-prob rtol 1e-5."""
    logits = random_logits(np.random.default_rng(3), 256)
    key = jax.random.key(4)
    ja, jlp = jmlp.multi_categorical_sample(
        key, tuple(jnp.asarray(l) for l in logits))
    u = jax.random.uniform(key, (256, 5, 35), minval=1e-12, maxval=1.0)
    ta, tlp = multi_categorical_sample(
        tuple(torch.from_numpy(l) for l in logits),
        u=torch.tensor(np.asarray(u)))
    assert ta.dtype == torch.int32 and ta.shape == (256, 5)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5)
    # a drawn sample lands inside every head's range
    ts, _ = multi_categorical_sample(
        tuple(torch.from_numpy(l) for l in logits),
        generator=torch.Generator().manual_seed(0))
    assert (ts < torch.tensor(SIZES, dtype=torch.int32)).all()


def test_log_prob_and_entropy_match():
    """``multi_categorical_log_prob`` / ``_entropy``: rtol 1e-5; the
    entropy's gradient is finite despite the -inf padding."""
    rng = np.random.default_rng(5)
    logits = random_logits(rng, 128)
    acts = np.stack([rng.integers(0, s, 128) for s in SIZES],
                    axis=1).astype(np.int32)
    jt = tuple(jnp.asarray(l) for l in logits)
    tt = tuple(torch.from_numpy(l).requires_grad_() for l in logits)
    np.testing.assert_allclose(
        multi_categorical_log_prob(tt, torch.from_numpy(acts))
        .detach().numpy(),
        np.asarray(jmlp.multi_categorical_log_prob(jt, jnp.asarray(acts))),
        rtol=1e-5)
    ent = multi_categorical_entropy(tt)
    np.testing.assert_allclose(
        ent.detach().numpy(),
        np.asarray(jmlp.multi_categorical_entropy(jt)), rtol=1e-5)
    ent.sum().backward()
    for t in tt:
        assert torch.isfinite(t.grad).all()
        assert float(t.grad.abs().max()) > 0
