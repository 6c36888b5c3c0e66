"""The port's GPT policy, its action distribution and ``gpt_agent``
against ``arcle_tpu``.

The same inputs, made from a seed with numpy, go through both packages;
weights cross over through ``arcle_tpu_torch.models.convert``.  The JAX
GPT takes its dense attention at T < 1024 (10x10 grids, T=237) and its
streaming online-softmax at 30x30 (T=1837); the port has one attention
(``F.scaled_dot_product_attention``) for both.  Tolerances:

* float32: the largest difference of every output is within 1e-5 of the
  output's largest magnitude (measured ~2e-6: summation order only);
* bf16: within 0.2 of the output's largest float32 magnitude.  Loose on
  purpose: bf16 keeps ~3 significant digits, the two packages round at
  other places, and the heads' outputs (~1e-2, from a last layer of gain
  0.01) are sums that cancel, so their bf16 error reaches ~14% of their
  size in either package; the float32 cases hold the semantics;
* samples and integer actions bit-exact given JAX's uniforms.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcle_tpu.envs import BatchedEnv as JBatchedEnv
from arcle_tpu.envs import reset_jit as j_reset_jit
from arcle_tpu.envs.core import make_reset_pool as j_make_reset_pool
from arcle_tpu.loaders import SyntheticLoader as JSyntheticLoader
from arcle_tpu.models import bbox_dist as jbd
from arcle_tpu.models.gpt import GPTConfig as JGPTConfig
from arcle_tpu.models.gpt import GPTPolicy as JGPTPolicy
from arcle_tpu.models.truncated_normal import TruncatedNormal as JTN
from arcle_tpu.ops import o2arc_table as j_o2arc
from arcle_tpu_torch.core import FIELDS, state_from_numpy
from arcle_tpu_torch.envs import BatchedEnv, ResetPool
from arcle_tpu_torch.envs.core import BatchedState
from arcle_tpu_torch.loaders import SyntheticLoader
from arcle_tpu_torch.models import (
    GPTConfig, GPTPolicy, TruncatedNormal, bbox_dist, active_mask,
    gpt_state_dict_from_flax,
)
from arcle_tpu_torch.ops import o2arc_table

jagents, jroll = (importlib.import_module(f"arcle_tpu.training.{m}")
                  for m in ("agents", "rollout"))
tagents, troll = (importlib.import_module(f"arcle_tpu_torch.training.{m}")
                  for m in ("agents", "rollout"))

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(n_layer=2, n_head=2, n_embd=16)


def to_torch(x):
    return torch.tensor(np.asarray(x))


def npy(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def tight(actual, desired, what=""):
    """float32: max |a - d| <= 1e-5 * max |d|."""
    a, d = npy(actual), npy(desired)
    assert a.shape == d.shape, (what, a.shape, d.shape)
    err, scale = np.abs(a - d).max(), np.abs(d).max()
    assert err <= 1e-5 * max(scale, 1e-6), (what, err, scale)


def uniforms(key, shape, low, high):
    return to_torch(jax.random.uniform(key, shape, minval=low, maxval=high))


# ---------------------------------------------------------------------------
# TruncatedNormal and the action distribution
# ---------------------------------------------------------------------------
def test_truncated_normal_matches():
    """``log_prob``, ``mean``, ``entropy`` and ``sample`` (given JAX's
    uniforms) over locs in (0, 1) and scales e^-20..e^2, the clamp of
    the normaliser included: rtol 1e-5 / atol 1e-5 (erf and erfinv are
    implemented apart)."""
    rng = np.random.default_rng(0)
    n = 512
    loc = rng.uniform(0.0, 1.0, n).astype(np.float32)
    scale = np.exp(rng.uniform(-20.0, 2.0, n)).astype(np.float32)
    value = rng.uniform(0.0, 1.0, n).astype(np.float32)
    jt = JTN.create(jnp.asarray(loc), jnp.asarray(scale), 0.0, 1.0)
    tt = TruncatedNormal.create(torch.tensor(loc), torch.tensor(scale),
                                0.0, 1.0)
    for name, j, t in (("log_prob", jt.log_prob(jnp.asarray(value)),
                        tt.log_prob(torch.tensor(value))),
                       ("mean", jt.mean(), tt.mean()),
                       ("entropy", jt.entropy(), tt.entropy())):
        np.testing.assert_allclose(npy(t), np.asarray(j), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    key = jax.random.key(3)
    u = uniforms(key, (n,), 1e-6, 1.0 - 1e-6)
    np.testing.assert_allclose(npy(tt.sample(u=u)), np.asarray(jt.sample(key)),
                               rtol=1e-5, atol=1e-5, err_msg="sample")
    assert np.isfinite(npy(tt.sample(torch.Generator().manual_seed(0)))).all()


def random_heads(rng, B, n_ops=35, bins=0):
    """Op logits and raw bbox heads; the std heads reach both clamps."""
    out = [rng.standard_normal((B, n_ops)).astype(np.float32) * 2,
           rng.standard_normal((B, n_ops, 4)).astype(np.float32),
           (rng.standard_normal((B, n_ops, 4)) * 8).astype(np.float32)]
    if bins:
        out.append(rng.standard_normal((B, n_ops, 4, bins))
                   .astype(np.float32))
    return out


@pytest.mark.parametrize("kw", [{}, {"min_log_std": -2.3},
                                {"quantized_log_prob": True}],
                         ids=["default", "min_log_std", "quantized"])
def test_bbox_sample_matches(kw):
    """``bbox_dist.sample`` given JAX's Gumbel and bbox uniforms: op and
    bbox bit-exact, the log-prob rtol 1e-5 / atol 1e-4 (log-probs reach
    ~1e1 where the std clamps at e^-20); deterministic mode too; then
    ``log_prob`` and ``entropy`` of the drawn actions."""
    rng = np.random.default_rng(1)
    B = 256
    logits, mean_all, std_all = random_heads(rng, B)
    J = [jnp.asarray(a) for a in (logits, mean_all, std_all)]
    T = [torch.tensor(a) for a in (logits, mean_all, std_all)]
    key = jax.random.key(7)
    k_op, k_bb = jax.random.split(key)
    u_op = uniforms(k_op, (B, 35), float(jnp.finfo(jnp.float32).tiny), 1.0)
    u_bb = uniforms(k_bb, (B, 4), 1e-6, 1.0 - 1e-6)
    for det in (False, True):
        js = jbd.sample(key, *J, 30, det, **kw)
        ts = bbox_dist.sample(*T, 30, det, u_op=u_op, u_bbox=u_bb, **kw)
        np.testing.assert_array_equal(ts.operation.numpy(),
                                      np.asarray(js.operation))
        np.testing.assert_array_equal(ts.bbox.numpy(), np.asarray(js.bbox))
        np.testing.assert_allclose(npy(ts.log_prob), np.asarray(js.log_prob),
                                   rtol=1e-5, atol=1e-4)
    mls = kw.get("min_log_std", bbox_dist.MIN_LOG_STD)
    jl = jbd.log_prob(*J, js.operation, js.bbox, 30, mls)
    tl = bbox_dist.log_prob(*T, ts.operation, ts.bbox, 30, mls)
    np.testing.assert_allclose(npy(tl), np.asarray(jl), rtol=1e-5, atol=1e-4)
    je = jbd.entropy(*J, js.operation, mls)
    te = bbox_dist.entropy(*T, ts.operation, mls)
    np.testing.assert_allclose(npy(te), np.asarray(je), rtol=1e-5, atol=1e-4)
    tight(bbox_dist.select_op(T[1], ts.operation),
          jbd.select_op(J[1], js.operation), "select_op")


def test_bbox_categorical_head_matches():
    """The categorical head: ``sample_categorical`` (given JAX's
    uniforms; and deterministic) bit-exact in op and coordinates, its
    log-prob, ``log_prob_categorical`` and ``entropy_categorical`` rtol
    1e-5 / atol 1e-5."""
    rng = np.random.default_rng(2)
    B, bins = 256, 5
    logits, _, _, bl = random_heads(rng, B, bins=bins)
    key = jax.random.key(9)
    k_op, k_bb = jax.random.split(key)
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u_op = uniforms(k_op, (B, 35), tiny, 1.0)
    u_bb = uniforms(k_bb, (B, 4, bins), tiny, 1.0)
    JL, JB = jnp.asarray(logits), jnp.asarray(bl)
    TL, TB = torch.tensor(logits), torch.tensor(bl)
    for det in (False, True):
        js = jbd.sample_categorical(key, JL, JB, det)
        ts = bbox_dist.sample_categorical(TL, TB, det, u_op=u_op,
                                          u_bbox=u_bb)
        np.testing.assert_array_equal(ts.operation.numpy(),
                                      np.asarray(js.operation))
        np.testing.assert_array_equal(ts.bbox.numpy(), np.asarray(js.bbox))
        np.testing.assert_allclose(npy(ts.log_prob), np.asarray(js.log_prob),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        npy(bbox_dist.log_prob_categorical(TL, TB, ts.operation, ts.bbox)),
        np.asarray(jbd.log_prob_categorical(JL, JB, js.operation, js.bbox)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        npy(bbox_dist.entropy_categorical(TL, TB, ts.operation)),
        np.asarray(jbd.entropy_categorical(JL, JB, js.operation)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# GPTPolicy
# ---------------------------------------------------------------------------
def gpt_inputs(rng, B, H, W):
    grid = rng.integers(0, 10, (B, H, W)).astype(np.int8)
    inp = rng.integers(0, 10, (B, H, W)).astype(np.int8)
    gd = np.stack([rng.integers(1, H + 1, B), rng.integers(1, W + 1, B)],
                  1).astype(np.int8)
    idd = np.stack([rng.integers(1, H + 1, B), rng.integers(1, W + 1, B)],
                   1).astype(np.int8)
    tr = rng.integers(0, 5, B).astype(np.int8)      # 4 clips to 3
    ac = rng.integers(0, 2, B).astype(np.int8)
    return grid, gd, inp, idd, tr, ac


def carried_gpt(jcfg_kw, dtype="f32", seed=0, B=3, H=30, W=30):
    """A flax GPTPolicy's params and the port's policy holding them."""
    rng = np.random.default_rng(seed)
    args = gpt_inputs(rng, B, H, W)
    jm = JGPTPolicy(JGPTConfig(grid_x=H, grid_y=W, dtype=DT[dtype][0],
                               **jcfg_kw))
    params = jax.jit(jm.init)(jax.random.key(seed), *args)
    tm = GPTPolicy(GPTConfig(grid_x=H, grid_y=W, dtype=DT[dtype][1],
                             **jcfg_kw))
    tm.load_state_dict(gpt_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    return jm, params, tm, args


ALL_FLAGS = {"color_equivariant": True, "factorized": True, "bbox_bins": 5}
GPT_CASES = {
    "10x10_f32": (10, "f32", {}),
    "10x10_bf16": (10, "bf16", {}),
    "30x30_f32": (30, "f32", {}),
    "bbox_bins": (10, "f32", {"bbox_bins": 5}),
    "equivariant_factorized_bins": (10, "f32", ALL_FLAGS),
    "30x30_bf16_equivariant_factorized_bins": (30, "bf16", ALL_FLAGS),
}


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_gpt_forward_matches(case):
    """Every output of both passes (plain and action-conditioned), at the
    tolerance of the module docstring for the case's dtype."""
    size, dtype, flags = GPT_CASES[case]
    jm, params, tm, args = carried_gpt({**SMALL, **flags}, dtype, H=size,
                                       W=size)
    rng = np.random.default_rng(5)
    op = rng.integers(0, 35, len(args[0]))
    op[0] = 4                                  # a color op, then others
    bb = rng.random((len(op), 4)).astype(np.float32)
    targs = [torch.tensor(a) for a in args]
    j32 = JGPTPolicy(JGPTConfig(grid_x=size, grid_y=size, dtype=jnp.float32,
                                **SMALL, **flags))
    for conditioned in (False, True):
        jkw = dict(operation=jnp.asarray(op), bbox=jnp.asarray(bb)) \
            if conditioned else {}
        tkw = dict(operation=torch.tensor(op), bbox=torch.tensor(bb)) \
            if conditioned else {}
        jo = jax.jit(jm.apply)(params, *args, **jkw)
        ref = jo if dtype == "f32" else \
            jax.jit(j32.apply)(params, *args, **jkw)
        with torch.no_grad():
            to = tm(*targs, **tkw)
        assert set(to) == set(jo)
        for k in jo:
            what = f"{case} conditioned={conditioned} {k}"
            if dtype == "f32":
                tight(to[k], jo[k], what)
                continue
            err = np.abs(npy(to[k]) - npy(jo[k])).max()
            scale = np.abs(npy(ref[k])).max()
            assert err <= 0.2 * scale, (what, err, scale)


def test_gpt_active_mask_matches():
    from arcle_tpu.models.gpt import active_mask as j_active_mask
    dims = np.array([[0, 0], [3, 7], [30, 30], [1, 30]], np.int8)
    expect = np.stack([np.asarray(j_active_mask(jnp.asarray(d), 30, 30))
                       for d in dims])
    np.testing.assert_array_equal(
        active_mask(torch.tensor(dims), 30, 30).numpy(), expect)


def test_gpt_init_matches_flax_distribution():
    """Every parameter's shape and name equal flax's, and its draw has the
    flax initialiser's statistics: lecun-normal kernels truncated at 2
    std, N(0, 1/features) embeddings, N(0, 0.02) tokens, N(0, 0.15)
    frequencies, orthogonal head kernels (gain sqrt 2, last 0.01), unit
    LayerNorm scales, zero biases.  Standard deviations within 15% of
    flax's (tensors of >= 1000 entries)."""
    cfg = dict(n_layer=1, n_head=4, n_embd=64, factorized=True,
               bbox_bins=3)
    jm, params, _, args = carried_gpt(cfg, B=2, H=10, W=10)
    flax_sd = gpt_state_dict_from_flax(jax.tree.map(np.asarray, params))
    tm = GPTPolicy(GPTConfig(**cfg, grid_x=10, grid_y=10,
                             dtype=torch.float32),
                   generator=torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    assert set(sd) == set(flax_sd)
    for k, f in flax_sd.items():
        t = sd[k]
        assert t.shape == f.shape, k
        if f.numel() == 1 or f.std() == 0:
            torch.testing.assert_close(t, f, rtol=0, atol=0, msg=k)
            continue
        if t.numel() >= 1000:
            ratio = float(t.std() / f.std())
            assert 0.85 < ratio < 1.15, (k, ratio)
        if k.endswith("weight") and "Dense_2" in k:            # gain 0.01
            w = t.double()
            gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            torch.testing.assert_close(gram, 1e-4 * torch.eye(len(gram),
                                       dtype=torch.float64), atol=1e-9,
                                       rtol=0, msg=k)
    blk = "block_0.SelfAttention_0.qkv.weight"
    std = (1.0 / 64) ** 0.5 / 0.87962566103423978
    assert float(sd[blk].abs().max()) <= 2 * std + 1e-6


def test_gpt_remat_gradients_under_functional_call():
    """Gradients of a loss through ``functional_call`` with a dict of
    parameters are the same with and without per-block recomputation
    (the recomputation must use the dict's tensors), and equal JAX's
    (rtol 1e-4, atol 1e-6 of the largest gradient)."""
    jm, params, tm, args = carried_gpt(dict(SMALL, remat=True), B=2, H=10,
                                       W=10)
    targs = [torch.tensor(a) for a in args]

    def jloss(p):
        o = jm.apply(p, *args)
        return (o["op_logits"] ** 2).sum() + o["value"].sum()

    jg = gpt_state_dict_from_flax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(jloss))(params)))
    grads = {}
    for remat in (True, False):
        tm.cfg = GPTConfig(grid_x=10, grid_y=10, dtype=torch.float32,
                           **SMALL, remat=remat)
        p = {k: v.detach().clone().requires_grad_()
             for k, v in tm.named_parameters()}
        o = torch.func.functional_call(tm, p, tuple(targs))
        loss = (o["op_logits"] ** 2).sum() + o["value"].sum()
        grads[remat] = dict(zip(p, torch.autograd.grad(
            loss, list(p.values()), allow_unused=True)))
    for k, g in grads[True].items():
        # the bbox encoder and the aux heads are off the loss's path
        g = torch.zeros_like(jg[k]) if g is None else g
        g2 = grads[False][k]
        torch.testing.assert_close(g, torch.zeros_like(g) if g2 is None
                                   else g2, rtol=1e-5, atol=1e-9, msg=k)
        scale = float(np.abs(jg[k].numpy()).max()) + 1e-12
        np.testing.assert_allclose(g.numpy(), jg[k].numpy(), rtol=1e-4,
                                   atol=1e-6 * max(scale, 1.0), err_msg=k)


# ---------------------------------------------------------------------------
# gpt_agent
# ---------------------------------------------------------------------------
def random_full_obs(rng, B):
    """Full 6314-wide observations with valid dims, flags and grids."""
    from arcle_tpu_torch.wrappers import FULL_OBS_FIELDS
    parts = []
    for name, n in FULL_OBS_FIELDS:
        if n == 900:
            parts.append(rng.integers(0, 10, (B, n)))
        elif n == 2:
            parts.append(rng.integers(1, 31, (B, 2)))
        elif name == "trials_remain":
            parts.append(rng.integers(0, 4, (B, 1)))
        else:
            parts.append(rng.integers(0, 2, (B, 1)))
    return np.concatenate(parts, 1).astype(np.int8)


def test_gpt_agent_evaluate_and_aux_match():
    """``evaluate_fn`` (log-prob, value, entropy) and ``aux_fn`` on the
    same obs and actions, with the port's params given as the module and
    as a name -> tensor dict: float32, the tolerance ``tight``."""
    jm, params, tm, _ = carried_gpt(SMALL, B=2)
    rng = np.random.default_rng(4)
    B = 6
    obs = random_full_obs(rng, B)
    acts = np.concatenate([rng.integers(0, 30, (B, 4)),
                           rng.integers(0, 35, (B, 1))], 1).astype(np.int32)
    ja = jagents.gpt_agent(jm)
    ta = tagents.gpt_agent(tm)
    jout = jax.jit(ja.evaluate_fn)(params, jnp.asarray(obs),
                                   jnp.asarray(acts))
    jaux = jax.jit(ja.aux_fn)(params, jnp.asarray(obs), jnp.asarray(acts))
    pdict = dict(tm.named_parameters())
    with torch.no_grad():
        for p in (tm, pdict):
            tout = ta.evaluate_fn(p, torch.tensor(obs), torch.tensor(acts))
            for name, t, j in zip(("log_prob", "value", "entropy"), tout,
                                  jout):
                tight(t, j, name)
            taux = ta.aux_fn(p, torch.tensor(obs), torch.tensor(acts))
            for k in jaux:
                tight(taux[k], jaux[k], f"aux {k}")


B_ROLL, T_ROLL = 4, 5


@functools.lru_cache(maxsize=None)
def gpt_rollout():
    """A deterministic GPT rollout in both packages from JAX's start
    state, with JAX's reset-pool refresh injected."""
    kw = dict(max_trial=3, episode_limit=3, auto_reset=True,
              dense_reward=True, augment=True, reset_pool=2)
    jenv = JBatchedEnv(table=j_o2arc(3, crop_at_33=True),
                       bank=JSyntheticLoader(6, seed=0).bank(), **kw)
    tenv = BatchedEnv(table=o2arc_table(3, crop_at_33=True),
                      bank=SyntheticLoader(6, seed=0).bank(device="cpu"),
                      **kw)
    jm, params, _, _ = carried_gpt(dict(n_layer=1, n_head=2, n_embd=16),
                                   seed=3, B=2)
    # spread the op logits and move the bbox means off the cell edges
    # (at init every mean sits at 0.5, on an edge of the 30 cells)
    rng = np.random.default_rng(3)
    heads = params["params"]
    heads["head_operation"]["Dense_2"]["kernel"] *= 300.0
    heads["head_bbox_mean"]["Dense_2"]["bias"] = jnp.asarray(
        rng.uniform(-2.0, 2.0, 4), jnp.float32)
    tm = GPTPolicy(GPTConfig(n_layer=1, n_head=2, n_embd=16,
                             dtype=torch.float32))
    tm.load_state_dict(gpt_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    ja, ta = jagents.gpt_agent(jm), tagents.gpt_agent(tm)
    jbs = j_reset_jit(jenv, jax.random.key(0), B_ROLL)
    key = jax.random.key(2)
    jbs2, jtraj, jlast = jax.jit(jroll.rollout, static_argnums=(4, 5, 6))(
        jenv, jbs, params, key, T_ROLL, ja, True)
    _, kp = jax.random.split(key)
    jpool = jax.jit(j_make_reset_pool, static_argnums=(2,))(jenv, kp,
                                                            B_ROLL)
    pool = ResetPool(**{f: to_torch(getattr(jpool, f))
                        for f in ("grid", "dim", "answer", "answer_dim",
                                  "counter")})
    tbs = BatchedState(env=state_from_numpy(jbs.env),
                       generator=torch.Generator().manual_seed(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(troll, "make_reset_pool", lambda env, gen, batch: pool)
        tbs2, ttraj, tlast = troll.rollout(tenv, tbs, tm, None, T_ROLL, ta,
                                           True)
    return dict(tm=tm, ta=ta, jbs=jbs2, jtraj=jtraj, jlast=jlast, tbs=tbs2,
                ttraj=ttraj, tlast=tlast)


def test_gpt_deterministic_rollout_matches():
    """Argmax op and mean bbox: obs, actions, dones, terminated and the
    final carry bit-exact; log-probs, values, final values and the last
    value ``tight``.  Every step's top-2 op-logit margin and the bbox
    means' distance to a cell edge exceed 1e-4, far above the float32
    difference, so no argmax or floor can flip."""
    r = gpt_rollout()
    jt, tt = r["jtraj"], r["ttraj"]
    for name in ("obs", "actions", "dones", "terminated"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    np.testing.assert_allclose(npy(tt.rewards), np.asarray(jt.rewards),
                               rtol=1e-6)
    for name in ("log_probs", "values", "final_values"):
        tight(getattr(tt, name), getattr(jt, name), name)
    tight(r["tlast"], r["jlast"], "last_value")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(r["tbs"].env, name).numpy(),
                                      np.asarray(getattr(r["jbs"].env, name)),
                                      f"carry {name}")
    assert bool((tt.dones & ~tt.terminated).any())
    with torch.no_grad():
        f = tagents.unflatten_full(tt.obs.reshape(T_ROLL * B_ROLL, -1))
        out = r["tm"](f["grid"], f["grid_dim"], f["input"], f["input_dim"],
                      f["trials_remain"], f["active"])
    top2 = out["op_logits"].topk(2, dim=-1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4
    mean = bbox_dist.make_dist(out["bbox_mean_all"], out["bbox_std_all"],
                               tt.actions.reshape(-1, 5)[:, 4]).mean() * 30
    assert float((mean - mean.round()).abs().min()) > 1e-4
