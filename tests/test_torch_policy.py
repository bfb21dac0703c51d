"""The attention-graph policy: the PyTorch port against the JAX package with
the same params and observations, at a narrow width (attn_size 64, 8 heads).

The einsum attention branch runs on both sides in f32; value, action mean,
logstd and the new hidden state agree to atol 2e-5 (the bound of
tests/test_policy_parity.py:136). The port's kernel branch (folded weights,
plain K1 in f32 on the CPU) is held to the JAX einsum branch at 2e-4, the
bound tests/test_pallas_attention.py uses for its kernel-vs-einsum policy.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.models import policy as j_policy
from crowdnav_prediction_attngraph_tpu.models.policy_net import (
    init_hidden as j_init_hidden)
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.models import policy as t_policy
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (
    create_attn_mask, init_hidden)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree)

N, A, T = 5, 6, 3


def _cfgs(use_kernel=False):
    jc = jconfig.gst_config(human_num=A)
    jc = jc.replace(network=dataclasses.replace(
        jc.network, attn_size=64, use_pallas_attention=False))
    tc = tconfig.gst_config(human_num=A)
    tc = tc.replace(network=dataclasses.replace(
        tc.network, attn_size=64, use_pallas_attention=use_kernel,
        pallas_dtype="float32"))
    return jc, tc


def _obs(rng, lead):
    D = 12
    return {
        "robot_node": rng.randn(*lead, 7).astype(np.float32),
        "temporal_edges": rng.randn(*lead, 2).astype(np.float32),
        "spatial_edges": rng.randn(*lead, A, D).astype(np.float32),
        "visible_masks": rng.uniform(size=(*lead, A)) > 0.3,
        "detected_human_num": rng.randint(1, A + 1, lead).astype(np.int32),
    }


@pytest.fixture(scope="module")
def params():
    jc, _ = _cfgs()
    example = {k: jnp.asarray(v) for k, v in
               _obs(np.random.RandomState(0), (N,)).items()}
    tree = j_policy.init_params(jc, jax.random.key(1), example)
    # non-zero biases and logstd so every parameter matters
    rng = np.random.RandomState(2)
    return jax.tree.map(
        lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32) * 0.05,
        tree)


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("use_kernel,atol", [(False, 2e-5), (True, 2e-4)])
def test_recurrent_act_with_done_reset(params, use_kernel, atol):
    """Three act() steps; envs 1 and 3 hit done before the third."""
    jc, tc = _cfgs(use_kernel)
    model = t_policy.load_policy(tc, params, "cpu")
    j_act = jax.jit(lambda o, h, m: j_policy.act(
        jc, params, o, h, m, jax.random.key(0), deterministic=True))
    rng = np.random.RandomState(3)
    jh, th = j_init_hidden(jc, N), init_hidden(tc, N, "cpu")
    for t in range(T):
        obs = _obs(rng, (N,))
        masks = np.ones(N, np.float32)
        if t == 2:
            masks[[1, 3]] = 0.0
        jv, ja, jlp, jh = j_act({k: jnp.asarray(v) for k, v in obs.items()},
                                jh, jnp.asarray(masks))
        tv, ta, tlp, th = t_policy.act(model, _t(obs), th,
                                       torch.from_numpy(masks))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=atol)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=atol)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=atol)
        np.testing.assert_allclose(th["human_node_rnn"].numpy(),
                                   np.asarray(jh["human_node_rnn"]), atol=atol)


def test_time_major_forward_matches_jax(params):
    """The [T, N] forward (one GRU scan over T with a done mask)."""
    jc, tc = _cfgs()
    model = t_policy.load_policy(tc, params, "cpu")
    rng = np.random.RandomState(4)
    obs = _obs(rng, (T, N))
    masks = np.ones((T, N), np.float32)
    masks[1, 2] = 0.0
    jh = j_init_hidden(jc, N)
    jh["human_node_rnn"] = jnp.asarray(rng.randn(N, 1, 128).astype(np.float32))
    value, mean, logstd, h_new = j_policy.make_policy(jc).apply(
        params, {k: jnp.asarray(v) for k, v in obs.items()}, jh,
        jnp.asarray(masks))
    with torch.no_grad():
        tv, tm, tls, th = model(_t(obs), _t(jh), torch.from_numpy(masks))
    for g, e in ((tv, value), (tm, mean), (tls, logstd),
                 (th["human_node_rnn"], h_new["human_node_rnn"])):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(e),
                                   atol=2e-5)


def test_create_attn_mask_matches_sentinel_cumsum():
    from crowdnav_prediction_attngraph_tpu.models.policy_net import (
        create_attn_mask as j_create_attn_mask)
    lens = np.arange(0, A + 1)
    expect = np.asarray(j_create_attn_mask(jnp.asarray(lens), len(lens), A))
    got = create_attn_mask(torch.from_numpy(lens), A).numpy()
    np.testing.assert_array_equal(got, expect)


def test_state_dict_covers_every_param(params):
    _, tc = _cfgs()
    model = t_policy.load_policy(tc, params, "cpu")
    n_tree = sum(v.size for v in flatten_tree(params).values())
    assert n_tree == sum(p.numel() for p in model.parameters())
