"""PPO in the PyTorch port against the JAX package, at a narrow width
(attn_size 64, 8 heads, 6 humans, 4 envs, T = 3).

Inputs are a synthetic RolloutBatch made from a numpy seed (no env, so no
GST program is compiled), and both sides start from the same params.

* evaluate_actions: values, log_probs and entropy to atol 2e-5 (the policy
  bound of tests/test_policy_parity.py:136).
* The PPO loss gradient for one minibatch: through the einsum branch to
  1e-4 relative, per entry and against the largest entry of the gradient
  (same math, f32 sums in another order, through a 3-step GRU; some
  leaves, such as the k biases, have a gradient that is zero up to float
  noise, as softmax ignores a shift of every logit in a row); through the
  kernel branch in f32 (the port's K1/K2 plain versions, the JAX package's
  K1/K2 Pallas kernels in interpret mode) to the same bound: both sides are
  f32, and the attention leaves' own entries (q/k_linear about 2e-3 at
  most) are smaller than an absolute 5e-3 would notice.
* compute_returns, both use_gae and both use_proper_time_limits values:
  atol 1e-5 (tests/test_ppo.py:47).
* ppo_update, 2 epochs x 2 minibatches, einsum branch, with the
  permutations JAX draws from the same key passed in: metrics to 1e-4
  relative. Params after the update to 2 * n_updates * lr absolute: Adam
  divides each gradient by its own running magnitude, so an entry whose
  gradient is zero up to float noise (the k biases: softmax ignores a shift
  of every logit in a row) takes a +-lr step of either sign on either side;
  every other entry must move the same way on both sides (checked on the
  update itself, relative to its norm).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from crowdnav_prediction_attngraph_tpu import config as jconfig
from crowdnav_prediction_attngraph_tpu.algo import ppo as j_ppo
from crowdnav_prediction_attngraph_tpu.algo.gae import (
    compute_returns as j_compute_returns)
from crowdnav_prediction_attngraph_tpu.models import policy as j_policy
from crowdnav_prediction_attngraph_tpu_torch import config as tconfig
from crowdnav_prediction_attngraph_tpu_torch.algo import ppo as t_ppo
from crowdnav_prediction_attngraph_tpu_torch.algo.gae import compute_returns
from crowdnav_prediction_attngraph_tpu_torch.models import policy as t_policy
from crowdnav_prediction_attngraph_tpu_torch.utils.params import (
    flatten_tree, state_dict_to_tree)

N, A, T = 4, 6, 3


def _cfgs(use_kernel=False, **ppo):
    ppo = dict(num_processes=N, num_steps=T, ppo_epoch=2, num_mini_batch=2,
               lr=1e-3, **ppo)
    out = []
    for mod in (jconfig, tconfig):
        c = mod.gst_config(human_num=A)
        out.append(c.replace(
            network=dataclasses.replace(
                c.network, attn_size=64, use_pallas_attention=use_kernel,
                pallas_dtype="float32"),
            ppo=dataclasses.replace(c.ppo, **ppo)))
    return out


def _obs(rng, lead):
    D = 12
    return {
        "robot_node": rng.randn(*lead, 7).astype(np.float32),
        "temporal_edges": rng.randn(*lead, 2).astype(np.float32),
        "spatial_edges": rng.randn(*lead, A, D).astype(np.float32),
        "visible_masks": rng.uniform(size=(*lead, A)) > 0.3,
        "detected_human_num": rng.randint(1, A + 1, lead).astype(np.int32),
    }


def make_batch(seed=0):
    """A numpy RolloutBatch: (T+1, N) obs, done and time-limit masks."""
    rng = np.random.RandomState(seed)
    masks = (rng.rand(T + 1, N) > 0.2).astype(np.float32)
    masks[0] = 1.0
    return dict(
        obs=_obs(rng, (T + 1, N)),
        hxs0={"human_node_rnn": rng.randn(N, 1, 128).astype(np.float32) * .5},
        actions=rng.randn(T, N, 2).astype(np.float32),
        log_probs=(rng.randn(T, N, 1) - 2.0).astype(np.float32),
        values=rng.randn(T + 1, N, 1).astype(np.float32),
        rewards=rng.randn(T, N).astype(np.float32),
        masks=masks,
        bad_masks=(rng.rand(T + 1, N) > 0.2).astype(np.float32),
        done_returns=np.full((T, N), np.nan, np.float32),
        done_returns_env=np.full((T, N), np.nan, np.float32))


def to_jax_batch(b, jc):
    hxs0 = {"human_node_rnn": jnp.asarray(b["hxs0"]["human_node_rnn"]),
            "human_human_edge_rnn": jnp.zeros(
                (N, A + 1, jc.network.human_human_edge_rnn_size))}
    return j_ppo.RolloutBatch(
        obs={k: jnp.asarray(v) for k, v in b["obs"].items()}, hxs0=hxs0,
        **{k: jnp.asarray(b[k]) for k in (
            "actions", "log_probs", "values", "rewards", "masks",
            "bad_masks", "done_returns", "done_returns_env")})


def to_port_batch(b):
    t = torch.from_numpy
    return t_ppo.RolloutBatch(
        obs={k: t(v) for k, v in b["obs"].items()},
        hxs0={k: t(v) for k, v in b["hxs0"].items()},
        **{k: t(b[k]) for k in (
            "actions", "log_probs", "values", "rewards", "masks",
            "bad_masks", "done_returns", "done_returns_env")})


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


def j_loss_fn(jc, batch, returns, adv_n, idx):
    """The JAX package's minibatch loss (``ppo.py:187-215``, a closure
    there), written out over the same pieces."""
    p = jc.ppo

    def loss(params):
        take = lambda x: jnp.take(x, idx, axis=1)
        obs_mb = {k: take(v[:-1]) for k, v in batch.obs.items()}
        hxs_mb = jax.tree.map(lambda x: jnp.take(x, idx, axis=0), batch.hxs0)
        values, log_probs, entropy = j_policy.evaluate_actions(
            jc, params, obs_mb, hxs_mb, take(batch.masks[:-1]),
            take(batch.actions))
        values = values[:, :, 0]
        vpred_old = take(batch.values[:-1, :, 0])
        ret_mb, adv_mb = take(returns), take(adv_n)
        ratio = jnp.exp(log_probs[:, :, 0] - take(batch.log_probs)[:, :, 0])
        surr2 = jnp.clip(ratio, 1.0 - p.clip_param, 1.0 + p.clip_param)
        action_loss = -jnp.mean(jnp.minimum(ratio * adv_mb, surr2 * adv_mb))
        v_clipped = vpred_old + jnp.clip(values - vpred_old, -p.clip_param,
                                         p.clip_param)
        value_loss = 0.5 * jnp.mean(jnp.maximum((values - ret_mb) ** 2,
                                                (v_clipped - ret_mb) ** 2))
        return (value_loss * p.value_loss_coef + action_loss
                - entropy * p.entropy_coef)
    return loss


def j_advantages(jc, batch):
    p = jc.ppo
    returns = j_compute_returns(batch.rewards, batch.values[:, :, 0],
                                batch.masks, batch.bad_masks, p.gamma,
                                p.gae_lambda, p.use_gae,
                                p.use_proper_time_limits)
    adv = returns - batch.values[:-1, :, 0]
    return returns, (adv - adv.mean()) / (jnp.std(adv, ddof=1) + 1e-5)


def test_evaluate_actions_matches_jax(params):
    jc, tc = _cfgs()
    b = make_batch(1)
    jb, tb = to_jax_batch(b, jc), to_port_batch(b)
    obs = {k: v[:-1] for k, v in jb.obs.items()}
    jv, jlp, jent = j_policy.evaluate_actions(jc, params, obs, jb.hxs0,
                                              jb.masks[:-1], jb.actions)
    model = t_policy.load_policy(tc, params, "cpu")
    tv, tlp, tent = t_policy.evaluate_actions(
        model, {k: v[:-1] for k, v in tb.obs.items()}, tb.hxs0, tb.masks[:-1],
        tb.actions)
    assert tv.requires_grad and tlp.requires_grad
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=2e-5)
    np.testing.assert_allclose(tlp.detach().numpy(), np.asarray(jlp),
                               atol=2e-5)
    np.testing.assert_allclose(tent.item(), float(jent), atol=2e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ppo_loss_gradient_matches_jax(params, use_kernel):
    jc, tc = _cfgs(use_kernel)
    b = make_batch(2)
    jb, tb = to_jax_batch(b, jc), to_port_batch(b)
    idx = np.array([3, 0])
    returns, adv_n = j_advantages(jc, jb)
    jloss, jgrad = jax.value_and_grad(
        j_loss_fn(jc, jb, returns, adv_n, jnp.asarray(idx)))(params)

    model = t_policy.load_policy(tc, params, "cpu")
    t_returns, t_adv = t_ppo.advantages(tc, tb)
    tloss, _ = t_ppo.ppo_loss(tc, model, tb, t_returns, t_adv,
                              torch.from_numpy(idx))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    expect = flatten_tree(jgrad["params"])
    got = flatten_tree(state_dict_to_tree(
        {k: p.grad for k, p in model.named_parameters()}))
    assert set(got) == set(expect)
    gmax = max(np.abs(np.asarray(e)).max() for e in expect.values())
    for name in expect:
        np.testing.assert_allclose(got[name], np.asarray(expect[name]),
                                   rtol=1e-4, atol=1e-4 * gmax, err_msg=name)


@pytest.mark.parametrize("use_gae", [True, False])
@pytest.mark.parametrize("proper", [False, True])
def test_compute_returns_matches_jax(use_gae, proper):
    rng = np.random.RandomState(int(use_gae) * 2 + int(proper))
    steps, n = 30, 4
    rewards = rng.randn(steps, n).astype(np.float32)
    values = rng.randn(steps + 1, n).astype(np.float32)
    masks = (rng.rand(steps + 1, n) > 0.1).astype(np.float32)
    bad = (rng.rand(steps + 1, n) > 0.05).astype(np.float32)
    args = (0.99, 0.95, use_gae, proper)
    expect = j_compute_returns(*map(jnp.asarray, (rewards, values, masks,
                                                  bad)), *args)
    got = compute_returns(*map(torch.from_numpy, (rewards, values, masks,
                                                  bad)), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), atol=1e-5)


def test_ppo_update_matches_jax(params):
    jc, tc = _cfgs(use_linear_lr_decay=True, num_env_steps=2 * N * T)
    b = make_batch(3)
    jb, tb = to_jax_batch(b, jc), to_port_batch(b)
    key = jax.random.key(7)
    tx = j_ppo.make_optimizer(jc)
    jparams, _, jm = jax.jit(lambda p, s, bb, k: j_ppo.ppo_update(
        jc, p, s, bb, k))(params, tx.init(params), jb, key)
    # the permutations ppo_update draws from its key (ppo.py:183-184)
    perms = jax.vmap(lambda k: jax.random.permutation(k, N))(
        jax.random.split(key, jc.ppo.ppo_epoch))

    model = t_policy.load_policy(tc, params, "cpu")
    optimizer, schedule = t_ppo.make_optimizer(tc, model.parameters())
    tm = t_ppo.ppo_update(tc, model, optimizer, schedule, tb,
                          perms=torch.from_numpy(np.array(perms)))
    for k in ("value_loss", "action_loss", "dist_entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    # the schedule decayed over 2 updates x 4 Adam steps, as optax's did
    n_updates = jc.ppo.ppo_epoch * jc.ppo.num_mini_batch
    assert schedule.get_last_lr()[0] == pytest.approx(
        float(optax.linear_schedule(jc.ppo.lr, 0.0, 2 * n_updates)(n_updates)))

    before = flatten_tree(params["params"])
    expect = flatten_tree(jparams["params"])
    got = flatten_tree(state_dict_to_tree(model.state_dict()))
    bound = 2 * n_updates * jc.ppo.lr
    d_port, d_jax = [], []
    for name in expect:
        e = np.asarray(expect[name])
        np.testing.assert_allclose(got[name], e, atol=bound, rtol=0,
                                   err_msg=name)
        d_port.append((got[name] - before[name]).ravel())
        d_jax.append((e - before[name]).ravel())
    d_port, d_jax = np.concatenate(d_port), np.concatenate(d_jax)
    assert np.linalg.norm(d_jax) > 10 * bound     # the update moved params
    assert np.linalg.norm(d_port - d_jax) <= 0.1 * np.linalg.norm(d_jax)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.RandomState(5)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        expect, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        t_ppo.clip_by_global_norm(got, max_norm)
        for g, e in zip(got, expect):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6)


def test_init_params_follows_the_jax_initializers():
    """Fresh params have the JAX package's tree, zeros where it has zeros,
    and per-leaf spreads within 10% of a JAX init's at full width."""
    jc = jconfig.gst_config(human_num=A)
    tc = tconfig.gst_config(human_num=A)
    example = {k: jnp.asarray(v) for k, v in
               _obs(np.random.RandomState(0), (N,)).items()}
    jtree = flatten_tree(jax.tree.map(
        np.asarray, j_policy.init_params(jc, jax.random.key(0),
                                         example))["params"])
    model = t_policy.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    ttree = flatten_tree(state_dict_to_tree(model.state_dict()))
    assert set(ttree) == set(jtree)
    for name, e in jtree.items():
        g = ttree[name]
        assert g.shape == e.shape, name
        if not e.any():
            assert not g.any(), name
            continue
        assert g.std() == pytest.approx(e.std(), rel=0.1), name
        assert np.abs(g).max() <= np.abs(e).max() * 1.5, name
