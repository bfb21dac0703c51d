"""The policy ablations and DS-RNN: the port against the JAX package with the
same params, at a narrow width (attn_size 64, 8 heads, 6 humans).

Variants: ``sort_humans=False`` (the env's scattered visibility mask, with
column 0 forced valid on rows that see nobody), ``use_self_attn=False``,
``use_hr_attn=False``, ``use_ring_attention=True`` without a process group
(the dense branch, as the JAX package without a mesh) and DS-RNN
(``robot.policy = "srnn"``).

* The [T, N] forward with a done reset: value, action mean, logstd and every
  hidden slot to atol 2e-5 (tests/test_torch_policy.py:98-116), einsum
  branch on both sides; ``sort_humans=False`` also through the port's
  kernel branch (plain K1 in f32 on the CPU, with scattered masks) to the
  2e-4 of tests/test_torch_policy.py's kernel case.
* ``evaluate_actions`` and one ``ppo_update`` (2 epochs x 2 minibatches)
  from the same batch for DS-RNN and ``sort_humans=False``, to
  tests/test_torch_ppo.py:230-267's bounds.
* The weight carrier (``tree_to_state_dict`` / ``state_dict_to_tree``) both
  ways on each variant's tree, and ``init_params`` giving the JAX tree.
* A ``use_ring_attention=True`` train iteration without a process group,
  the same bits as the dense config's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.algo import ppo as j_ppo
from crowdnav_prediction_attngraph_tpu.models import policy as j_policy
from crowdnav_prediction_attngraph_tpu.models.policy_net import (
    init_hidden as j_init_hidden)
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo as t_ppo
from crowdnav_prediction_attngraph_tpu_torch.models import policy as t_policy
from crowdnav_prediction_attngraph_tpu_torch.models.policy_net import (
    init_hidden)
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, state_dict_to_tree, tree_to_state_dict)
from test_torch_ppo import make_batch, to_port_batch

N, A, T = 4, 6, 3
VARIANTS = {
    "sort_humans_false": ("selfAttn_merge_srnn", dict(sort_humans=False)),
    "no_self_attn": ("selfAttn_merge_srnn", dict(use_self_attn=False)),
    "no_hr_attn": ("selfAttn_merge_srnn", dict(use_hr_attn=False)),
    "ring_no_group": ("selfAttn_merge_srnn", dict(use_ring_attention=True)),
    "srnn": ("srnn", {}),
}


def _cfgs(variant, use_kernel=False, width=64, **ppo):
    policy, net = VARIANTS[variant]
    ppo = dict(num_processes=N, num_steps=T, ppo_epoch=2, num_mini_batch=2,
               lr=1e-3, **ppo)
    out = []
    for mod, kernel in ((jconfig, False), (tconfig, use_kernel)):
        c = mod.gst_config(human_num=A)
        out.append(c.replace(
            robot=dataclasses.replace(c.robot, policy=policy),
            network=dataclasses.replace(
                c.network, attn_size=width, use_pallas_attention=kernel,
                pallas_dtype="float32", **net),
            ppo=dataclasses.replace(c.ppo, **ppo)))
    return out


def _obs(rng, lead):
    """Observations whose visibility is scattered, with rows that see
    nobody (the column-0 fallback of sort_humans=False)."""
    vis = rng.uniform(size=(*lead, A)) > 0.5
    vis.reshape(-1, A)[::5] = False
    return {
        "robot_node": rng.randn(*lead, 7).astype(np.float32),
        "temporal_edges": rng.randn(*lead, 2).astype(np.float32),
        "spatial_edges": rng.randn(*lead, A, 12).astype(np.float32),
        "visible_masks": vis,
        "detected_human_num": np.maximum(vis.sum(-1), 1).astype(np.int32),
    }


def _hidden(rng, jc, srnn):
    h = {"human_node_rnn": rng.randn(N, 1, 128).astype(np.float32) * .5}
    if srnn:
        h["human_human_edge_rnn"] = rng.randn(
            N, A + 1, jc.network.human_human_edge_rnn_size).astype(
                np.float32) * .5
    return h


def _jax_hidden(jc, h):
    out = j_init_hidden(jc, N)
    return {k: jnp.asarray(h.get(k, out[k])) for k in out}


_params = {}


def params_for(variant):
    """JAX init params of the variant, with noise on every leaf so biases
    and logstd matter."""
    if variant not in _params:
        jc, _ = _cfgs(variant)
        example = {k: jnp.asarray(v) for k, v in
                   _obs(np.random.RandomState(0), (N,)).items()}
        tree = j_policy.init_params(jc, jax.random.key(1), example)
        rng = np.random.RandomState(2)
        _params[variant] = jax.tree.map(
            lambda x: np.asarray(x)
            + rng.randn(*x.shape).astype(np.float32) * 0.05, tree)
    return _params[variant]


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("variant,use_kernel,atol", [
    ("sort_humans_false", False, 2e-5), ("sort_humans_false", True, 2e-4),
    ("no_self_attn", False, 2e-5), ("no_hr_attn", False, 2e-5),
    ("ring_no_group", False, 2e-5), ("ring_no_group", True, 2e-4),
    ("srnn", False, 2e-5)])
def test_time_major_forward_matches_jax(variant, use_kernel, atol):
    jc, tc = _cfgs(variant, use_kernel)
    params = params_for(variant)
    model = t_policy.load_policy(tc, params, "cpu")
    rng = np.random.RandomState(4)
    obs = _obs(rng, (T, N))
    masks = np.ones((T, N), np.float32)
    masks[1, 2] = masks[2, 0] = 0.0
    h = _hidden(rng, jc, variant == "srnn")
    value, mean, logstd, h_new = j_policy.make_policy(jc).apply(
        params, {k: jnp.asarray(v) for k, v in obs.items()},
        _jax_hidden(jc, h), jnp.asarray(masks))
    with torch.no_grad():
        tv, tm, tls, th = model(_t(obs), _t(h), torch.from_numpy(masks))
    assert set(th) == set(h)
    # init_hidden has the slots the base reads, in the JAX package's shapes
    assert {k: tuple(v.shape) for k, v in init_hidden(tc, N, "cpu").items()} \
        == {k: v.shape for k, v in h.items()}
    for g, e, name in ((tv, value, "value"), (tm, mean, "mean"),
                       (tls, logstd, "logstd"),
                       *((th[k], h_new[k], k) for k in th)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(e),
                                   atol=atol, err_msg=name)


def test_scattered_mask_reaches_the_kernel():
    """sort_humans=False hands K1 the env's visibility (not a prefix), with
    column 0 set on rows that see nobody."""
    _, tc = _cfgs("sort_humans_false", use_kernel=True)
    model = t_policy.load_policy(tc, params_for("sort_humans_false"), "cpu")
    seen = []
    attn = model.base.spatial_attn
    orig = attn.forward

    def record(inp, mask, *a, **kw):
        seen.append(mask.clone())
        return orig(inp, mask, *a, **kw)
    attn.forward = record
    obs = _obs(np.random.RandomState(5), (T, N))
    with torch.no_grad():
        model(_t(obs), _t(_hidden(np.random.RandomState(6), None, False)),
              torch.ones(T, N))
    vis = obs["visible_masks"].reshape(-1, A)
    expect = vis.copy()
    expect[~vis.any(-1), 0] = True
    np.testing.assert_array_equal(seen[0].numpy(), expect)
    prefix = np.arange(A)[None] < expect.sum(-1)[:, None]
    assert (expect != prefix).any()


def _batches(variant, seed):
    """The same RolloutBatch for both packages (tests/test_torch_ppo.py's
    make_batch, observations with scattered visibility, the DS-RNN edge
    hidden state drawn too)."""
    jc, _ = _cfgs(variant)
    b = make_batch(seed)
    rng = np.random.RandomState(seed + 100)
    b["obs"] = _obs(rng, (T + 1, N))
    b["hxs0"] = _hidden(rng, jc, variant == "srnn")
    jb = j_ppo.RolloutBatch(
        obs={k: jnp.asarray(v) for k, v in b["obs"].items()},
        hxs0=_jax_hidden(jc, b["hxs0"]),
        **{k: jnp.asarray(b[k]) for k in (
            "actions", "log_probs", "values", "rewards", "masks",
            "bad_masks", "done_returns", "done_returns_env")})
    return jb, to_port_batch(b)


@pytest.mark.parametrize("variant", ["srnn", "sort_humans_false"])
def test_evaluate_actions_matches_jax(variant):
    jc, tc = _cfgs(variant)
    params = params_for(variant)
    jb, tb = _batches(variant, 1)
    jv, jlp, jent = j_policy.evaluate_actions(
        jc, params, {k: v[:-1] for k, v in jb.obs.items()}, jb.hxs0,
        jb.masks[:-1], jb.actions)
    model = t_policy.load_policy(tc, params, "cpu")
    tv, tlp, tent = t_policy.evaluate_actions(
        model, {k: v[:-1] for k, v in tb.obs.items()}, tb.hxs0,
        tb.masks[:-1], tb.actions)
    assert tv.requires_grad and tlp.requires_grad
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=2e-5)
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp),
                               atol=2e-5)
    np.testing.assert_allclose(tent.item(), float(jent), atol=2e-5)


@pytest.mark.parametrize("variant", ["srnn", "sort_humans_false"])
def test_ppo_update_matches_jax(variant):
    """tests/test_torch_ppo.py::test_ppo_update_matches_jax on the variant:
    metrics to 1e-4 relative, params to 2 x n_updates x lr, and the update
    itself to 10% of its norm."""
    jc, tc = _cfgs(variant)
    params = params_for(variant)
    jb, tb = _batches(variant, 3)
    key = jax.random.key(7)
    tx = j_ppo.make_optimizer(jc)
    jparams, _, jm = jax.jit(lambda p, s, bb, k: j_ppo.ppo_update(
        jc, p, s, bb, k))(params, tx.init(params), jb, key)
    perms = jax.vmap(lambda k: jax.random.permutation(k, N))(
        jax.random.split(key, jc.ppo.ppo_epoch))
    model = t_policy.load_policy(tc, params, "cpu")
    optimizer, schedule = t_ppo.make_optimizer(tc, model.parameters())
    tm = t_ppo.ppo_update(tc, model, optimizer, schedule, tb,
                          perms=torch.from_numpy(np.array(perms)))
    for k in ("value_loss", "action_loss", "dist_entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    n_updates = jc.ppo.ppo_epoch * jc.ppo.num_mini_batch
    bound = 2 * n_updates * jc.ppo.lr
    before = flatten_tree(params["params"])
    expect = flatten_tree(jparams["params"])
    got = flatten_tree(state_dict_to_tree(model.state_dict()))
    assert set(got) == set(expect)
    d_port, d_jax = [], []
    for name in expect:
        e = np.asarray(expect[name])
        np.testing.assert_allclose(got[name], e, atol=bound, rtol=0,
                                   err_msg=name)
        d_port.append((got[name] - before[name]).ravel())
        d_jax.append((e - before[name]).ravel())
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    assert np.linalg.norm(d_jax) > 10 * bound
    assert np.linalg.norm(d_port - d_jax) <= 0.1 * np.linalg.norm(d_jax)


@pytest.mark.parametrize("variant", ["no_self_attn", "no_hr_attn", "srnn"])
def test_weight_carrier_and_init_follow_the_jax_tree(variant):
    """The variant's JAX tree loads strictly and comes back bit for bit;
    a fresh init_params at full width has the JAX tree's names, shapes and
    zero leaves, and the spread of its larger leaves within 10%."""
    jc, tc = _cfgs(variant)
    tree = params_for(variant)["params"]
    sd = tree_to_state_dict(tree)
    model = t_policy.PolicyHead(tc)
    model.load_state_dict(sd, strict=True)
    back = flatten_tree(state_dict_to_tree(model.state_dict()))
    flat = flatten_tree(tree)
    assert set(back) == set(flat)
    for name, v in flat.items():
        np.testing.assert_array_equal(back[name], v, err_msg=name)

    jc, tc = _cfgs(variant, width=512)
    example = {k: jnp.asarray(v) for k, v in
               _obs(np.random.RandomState(0), (N,)).items()}
    jtree = flatten_tree(jax.tree.map(np.asarray, j_policy.init_params(
        jc, jax.random.key(0), example))["params"])
    ttree = flatten_tree(state_dict_to_tree(t_policy.init_params(
        tc, torch.Generator().manual_seed(0), "cpu").state_dict()))
    assert set(ttree) == set(jtree)
    for name, e in jtree.items():
        g = ttree[name]
        assert g.shape == e.shape, name
        if not e.any():
            assert not g.any(), name
        elif e.size >= 1000:
            assert g.std() == pytest.approx(e.std(), rel=0.1), name


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ring_attention_train_iteration_without_a_process_group(use_kernel):
    """A train iteration (CrowdSimVarNum, 4 humans, 4 envs x 3 steps) with
    use_ring_attention=True and no process group runs the branch of
    use_ring_attention=False, einsum or kernel: the same bits."""
    assert not torch.distributed.is_initialized()
    base = tconfig.varnum_config(human_num=4)
    base = base.replace(
        network=dataclasses.replace(base.network, attn_size=64,
                                    use_pallas_attention=use_kernel),
        ppo=dataclasses.replace(base.ppo, num_processes=N, num_steps=T,
                                ppo_epoch=1))
    out = []
    for ring in (True, False):
        cfg = base.replace(network=dataclasses.replace(
            base.network, use_ring_attention=ring))
        ts = t_ppo.init_train_state(cfg, None, "cpu")
        ts, m = t_ppo.train_iteration(cfg, ts, None)
        out.append((m, ts.model.state_dict()))
    (m1, p1), (m2, p2) = out
    for k in ("value_loss", "action_loss", "dist_entropy", "reward_mean"):
        assert torch.equal(m1[k], m2[k]), k
    assert p1.keys() == p2.keys()
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
