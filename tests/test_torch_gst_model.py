"""The port's GST model for training against the JAX package's: losses, the
Gumbel softmax, the edge selector with and without ghost, the ghost node
encoder, the whole STModel with the edge selector under the JAX draws, the
temporal-convolution decoder, the weight converter's round trip and flax's
initializers.

JAX parameters come from flax ``init`` and are carried across with
``utils/params.py``; inputs come from numpy seeds; the JAX random draws are
fed to the port through its noise seam (``st_model.draw_noise``'s layout).
Small shapes: B <= 4, <= 8 pedestrian slots, embedding 16, 2 heads.
Tolerances, all f32:

* the losses: 1e-6 relative (the same elementwise formulas), with 1e-7
  absolute beside it: one f32 rounding of the NLL's O(1) terms, which
  cancel to values near 0.01;
* ``gumbel_softmax``, the edge selector, the ghost layer and the temporal
  convolution: 1e-5 absolute (one module; products summed in another
  order);
* STModel: 1e-4 absolute, the bound of tests/test_torch_gst.py (five
  recursive decoder steps feed their draws back);
* the round trip: exact; the init: each leaf's shape exactly and its
  standard deviation, pooled over 64 draws, within 10% of flax's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu.config import PredConfig as JPredConfig
from crowdnav_prediction_attngraph_tpu.models.gst import losses as jl
from crowdnav_prediction_attngraph_tpu.models.gst import st_model as jst
from crowdnav_prediction_attngraph_tpu.models.gst import trainer as jtrainer
from crowdnav_prediction_attngraph_tpu.models.gst.temporal_conv import (
    TemporalConvolutionNet as JTCN)
from crowdnav_prediction_attngraph_tpu_torch.config import PredConfig
from crowdnav_prediction_attngraph_tpu_torch.models.gst import losses as tl
from crowdnav_prediction_attngraph_tpu_torch.models.gst import st_model as tst
from crowdnav_prediction_attngraph_tpu_torch.models.gst.temporal_conv import (
    TemporalConvolutionNet)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, state_dict_to_tree, tree_to_state_dict)

SMALL = dict(embedding_size=16, spatial_num_heads=2, lstm_hidden_size=16,
             dim_feedforward=32)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tiny models run their ops on one thread: with the suite's
    workers sharing the cores, torch's intra-op threads only contend (a
    2 s training test took 80 s under load with them, 14 s without)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(**kw):
    """The same small PredConfig in both packages."""
    return (dataclasses.replace(JPredConfig(), **SMALL, **kw),
            dataclasses.replace(PredConfig(), **SMALL, **kw))


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def load(module, tree):
    module.load_state_dict(tree_to_state_dict(tree), strict=True)
    return module


def close(got, expect, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect),
                               atol=atol, rtol=0, err_msg=msg)


# ---------------------------------------------------------------- losses

def loss_inputs(seed, B=3, K=5, A=6):
    rng = np.random.RandomState(seed)
    mu = rng.normal(0, 0.5, (B, K, A, 2)).astype(np.float32)
    sx = np.exp(rng.normal(0, 0.3, (B, K, A, 1))).astype(np.float32)
    sy = np.exp(rng.normal(0, 0.3, (B, K, A, 1))).astype(np.float32)
    corr = np.tanh(rng.normal(0, 0.5, (B, K, A, 1))).astype(np.float32)
    x_t = rng.normal(0, 0.5, (B, K, A, 2)).astype(np.float32)
    lm_ped = (rng.uniform(size=(B, A)) > 0.3).astype(np.float32)
    lm_seq = (rng.uniform(size=(B, A, K)) > 0.2).astype(np.float32)
    return (mu, sx, sy, corr), x_t, lm_ped, lm_seq


def test_losses_match_jax():
    gp, x_t, lm_ped, lm_seq = loss_inputs(0)
    for name in ("negative_log_likelihood", "offset_error_square"):
        first = gp if name == "negative_log_likelihood" else gp[0]
        j_args = (jax.tree.map(jnp.asarray, first), jnp.asarray(x_t),
                  jnp.asarray(lm_ped), jnp.asarray(lm_seq))
        t_args = (jax.tree.map(t, first), t(x_t), t(lm_ped), t(lm_seq))
        for got, exp in zip(getattr(tl, name)(*t_args),
                            getattr(jl, name)(*j_args)):
            assert got.shape == exp.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(exp),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    for got, exp in zip(tl.offset_errors(t(gp[0]), t(x_t), t(lm_ped)),
                        jl.offset_errors(jnp.asarray(gp[0]), jnp.asarray(x_t),
                                         jnp.asarray(lm_ped))):
        assert got.shape == exp.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6)


# ----------------------------------------------------------- Gumbel softmax

@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax(hard):
    rng = np.random.RandomState(1)
    logits = rng.normal(0, 1, (4, 5, 2, 7)).astype(np.float32)
    w = rng.normal(0, 1, logits.shape).astype(np.float32)
    key = jax.random.key(3)
    u = jax.random.uniform(key, logits.shape)

    def j_obj(lg):
        y = jst.gumbel_softmax(key, lg, 0.5, hard)
        return jnp.sum(y * w), y
    (_, y_j), g_j = jax.value_and_grad(j_obj, has_aux=True)(
        jnp.asarray(logits))
    lg = t(logits).requires_grad_(True)
    y = tst.gumbel_softmax(t(u), lg, 0.5, hard)
    (y * t(w)).sum().backward()
    close(y, y_j, 1e-5, "sample")
    close(lg.grad, g_j, 1e-5, "straight-through gradient")
    if hard:
        assert set(np.unique(y.detach().numpy() + 0.0).round(5)) <= {0.0, 1.0}


def test_gumbel_hard_takes_first_maximum():
    # two equal maxima: the one-hot marks the first, as jnp.argmax does
    logits = torch.zeros(1, 3)
    y = tst.gumbel_softmax(torch.full((1, 3), 0.5), logits, 1.0, True)
    np.testing.assert_array_equal(y.detach().numpy(), [[1.0, 0.0, 0.0]])


# ---------------------------------------------------------- edge selector

def edge_inputs(seed, B=3, N=6):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-3, 3, (B, N, 2)).astype(np.float32)
    x = rng.normal(0, 0.3, (B, N, 2)).astype(np.float32)
    A = (pos[:, :, None] - pos[:, None]).astype(np.float32)
    valid = (rng.uniform(size=(B, N)) > 0.25).astype(np.float32)
    valid[:, 0] = 1.0
    mask = valid[:, :, None] * valid[:, None, :]
    return x, A, mask


@pytest.mark.parametrize("ghost", [False, True])
def test_edge_selector_matches_jax(ghost):
    x, A, mask = edge_inputs(2)
    B, N, _ = x.shape
    mod = jst.EdgeSelector(2, 16, nhead=2, ghost=ghost)
    key = jax.random.key(5)
    params = jax.jit(lambda k, *a: mod.init(k, *a, 0.5, False, key))(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(A), jnp.asarray(mask))
    port = load(tst.EdgeSelector(2, 16, nhead=2, ghost=ghost),
                params["params"])
    u = jax.random.uniform(key, (B, N, 2, N + int(ghost)))
    for hard in (False, True):
        m_j, s_j = jax.jit(lambda p, *a: mod.apply(p, *a, 0.5, hard, key))(
            params, jnp.asarray(x), jnp.asarray(A), jnp.asarray(mask))
        m_t, s_t = port(t(x), t(A), t(mask), 0.5, hard, t(u))
        close(m_t, m_j, 1e-5, "multinomial")
        close(s_t, s_j, 1e-5, f"sampled hard={hard}")


def test_ghost_node_encoder_matches_jax():
    rng = np.random.RandomState(4)
    B, N, D = 3, 6, 16
    x = rng.normal(0, 1, (B, N, D)).astype(np.float32)
    _, _, mask = edge_inputs(4, B, N)
    adj = np.concatenate([mask, np.ones((B, N, 1), np.float32)], axis=2)
    adj = adj * rng.uniform(0.2, 1.0, adj.shape).astype(np.float32)
    mod = jst.NodeEncoderLayer(D, 2, 32, ghost=True)
    params = jax.jit(mod.init)(jax.random.key(1), jnp.asarray(x),
                               jnp.asarray(adj), jnp.asarray(mask))
    # move the biases off zero so that the ghost row's k and v matter
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(2), p.shape),
        params)
    out_j, _ = jax.jit(mod.apply)(params, jnp.asarray(x), jnp.asarray(adj),
                                  jnp.asarray(mask))
    port = load(tst.NodeEncoderLayer(D, 2, 32, ghost=True), params["params"])
    close(port(t(x), t(adj), t(mask)), out_j, 1e-5)


# --------------------------------------------------------------- STModel

def model_inputs(seed, B=3, A=6, L=5, K=5):
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(-4, 4, (B, 1, A, 2))
           + rng.uniform(-0.3, 0.3, (B, L, A, 2)).cumsum(1)).astype(np.float32)
    present = rng.uniform(size=(B, L, A)) > 0.2
    present[:, -1, -1] = False                  # one ped gone at the end
    present[:, :, 0] = True
    rel = np.concatenate([present[:, :1], present[:, 1:] & present[:, :-1]],
                         axis=1).astype(np.float32)            # (B, L, A)
    v = np.diff(pos, axis=1, prepend=pos[:, :1]) * rel[..., None]
    A_e = (pos[:, :, :, None] - pos[:, :, None]) * (
        present[:, :, :, None, None] * present[:, :, None, :, None])
    attn = rel[..., :, None] * rel[..., None, :]
    lm = np.concatenate([rel.transpose(0, 2, 1),
                         np.repeat(rel[:, -1][..., None], K, -1)], -1)
    lm[0, 1, -1] = 0.0           # a ped not observed over the full period
    return (v.astype(np.float32), A_e.astype(np.float32),
            attn.astype(np.float32), lm.astype(np.float32))


def jax_noise(cfg, key, B, A):
    """The JAX STModel's draws for ``key`` in draw_noise's layout."""
    k_obs, k_dec, k_sample = jax.random.split(key, 3)
    keys = jax.random.split(k_dec, cfg.pred_seq_len - 1)
    shape = (A, cfg.spatial_num_heads_edges, A + int(cfg.ghost))
    noise = {"normal_first": jax.random.normal(k_sample, (B, 1, A, 2)),
             "normal_dec": jnp.stack([jax.random.normal(k, (B, 1, A, 2))
                                      for k in keys])}
    if cfg.spatial_num_heads_edges:
        noise["gumbel_obs"] = jax.random.uniform(
            k_obs, (B * cfg.obs_seq_len,) + shape)
        noise["gumbel_dec"] = jnp.stack([jax.random.uniform(k, (B,) + shape)
                                         for k in keys])
    return {k: t(v) for k, v in noise.items()}


@pytest.mark.parametrize("case,tau,hard,sampling", [
    (dict(spatial_num_heads_edges=2), 0.5, False, False),
    (dict(spatial_num_heads_edges=2), 0.3, True, True),
    (dict(spatial_num_heads_edges=2, ghost=True), 0.3, True, True),
    (dict(spatial_num_heads_edges=2, only_observe_full_period=True), 0.3,
     True, True),
    (dict(only_observe_full_period=True), 0.03, True, False),
])
def test_st_model_matches_jax(case, tau, hard, sampling):
    jc, tc = configs(**case)
    v, A_e, attn, lm = model_inputs(6)
    B, _, A, _ = v.shape
    j_args = tuple(jnp.asarray(a) for a in (v, A_e, attn, lm))
    key = jax.random.key(9)

    @jax.jit
    def run(k_init, *a):
        params = jtrainer.init_params(jc, k_init, A)
        return params, jst.STModel(jc).apply(params, *a, tau, hard, sampling,
                                             key)
    params, (gp_j, xs_j) = run(jax.random.key(0), *j_args)
    model = load(tst.STModel(tc), params["params"])
    gp_t, xs_t = model(t(v), t(attn), t(lm), t(A_e), tau, hard, sampling,
                       noise=jax_noise(jc, key, B, A))
    for name, g, e in zip(("mu", "sx", "sy", "corr"), gp_t, gp_j):
        close(g, e, 1e-4, name)
    close(xs_t, xs_j, 1e-4, "x_sample")


def test_st_model_generator_draws():
    """With a generator the model draws draw_noise's tensors from it."""
    _, tc = configs(spatial_num_heads_edges=2)
    v, A_e, attn, lm = (t(a) for a in model_inputs(7))
    model = tst.init_gst(tc, torch.Generator().manual_seed(0), "cpu")
    out = model(v, attn, lm, A_e, 0.5, True, True,
                generator=torch.Generator().manual_seed(3))
    noise = tst.draw_noise(tc, v.shape[0], v.shape[2], True,
                           torch.Generator().manual_seed(3), "cpu")
    again = model(v, attn, lm, A_e, 0.5, True, True, noise=noise)
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert torch.isfinite(out[1]).all()


# ------------------------------------------------------- temporal conv

def test_temporal_conv_matches_jax():
    rng = np.random.RandomState(8)
    x = rng.normal(0, 1, (3, 5, 6, 16)).astype(np.float32)
    kw = dict(in_channels=16, out_channels=5, dim_hidden=24, nconv=3,
              obs_seq_len=5, pred_seq_len=7, kernel_size=3)
    mod = JTCN(**kw)
    params = jax.jit(mod.init)(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(jax.random.key(1), p.shape),
        params)
    port = load(TemporalConvolutionNet(**kw), params["params"])
    close(port(t(x)), jax.jit(mod.apply)(params, jnp.asarray(x)), 1e-5)
    assert port.timeconv_0.weight.shape == (16, 16, 3, 1)


# ---------------------------------------------- weight converter, init

def test_new_leaves_round_trip():
    """Every EdgeSelector, ghost and TemporalConvolutionNet leaf (4-D conv
    kernels included) survives flax tree -> state_dict -> flax tree."""
    jc, tc = configs(spatial_num_heads_edges=2, ghost=True)
    trees = [(jax.jit(lambda k: jtrainer.init_params(jc, k, 6))(
        jax.random.key(0))["params"], tst.STModel(tc))]
    kw = dict(in_channels=8, out_channels=5, dim_hidden=12, obs_seq_len=5,
              pred_seq_len=5)
    trees.append((jax.jit(JTCN(**kw).init)(jax.random.key(1),
                                           jnp.zeros((1, 5, 3, 8)))["params"],
                  TemporalConvolutionNet(**kw)))
    for tree, module in trees:
        flat = flatten_tree(jax.tree.map(np.asarray, tree))
        load(module, tree)
        back = flatten_tree(state_dict_to_tree(module.state_dict()))
        assert set(back) == set(flat)
        for k in flat:
            assert back[k].shape == flat[k].shape, k
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert any(v.ndim == 4 for v in flat.values())


def test_init_matches_flax():
    jc, tc = configs(spatial_num_heads_edges=2)
    A, draws = 6, 64
    j_trees = jax.jit(jax.vmap(
        lambda k: jtrainer.init_params(jc, k, A)["params"]))(
        jax.random.split(jax.random.key(0), draws))
    j_flat = flatten_tree(jax.tree.map(np.asarray, j_trees))
    t_flat = [flatten_tree(state_dict_to_tree(tst.init_gst(
        tc, torch.Generator().manual_seed(i), "cpu").state_dict()))
        for i in range(draws)]
    assert set(t_flat[0]) == set(j_flat)
    for k, jv in j_flat.items():
        tv = np.stack([f[k] for f in t_flat])
        assert tv.shape == jv.shape, k
        j_std, t_std = jv.std(), tv.std()
        if j_std == 0:
            np.testing.assert_array_equal(tv, jv, err_msg=k)
        else:
            assert abs(t_std / j_std - 1) < 0.1, (k, t_std, j_std)
