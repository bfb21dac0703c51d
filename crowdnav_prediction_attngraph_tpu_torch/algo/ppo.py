"""Recurrent PPO (JAX package ``algo/ppo.py``; reference rl/ppo/ppo.py:36-101
and train.py:144-242).

One iteration is a T-step rollout of the vectorized env (policy ``act`` with
sampled actions -> ``vec_step`` with auto-reset and, in the GST env, the
GST pretext pass), the bootstrap value, GAE, then ``ppo_epoch`` x
``num_mini_batch`` Adam steps
on the clipped surrogate, the clipped value loss and the entropy bonus, with
the gradients clipped by their global norm as optax clips them. Where the
JAX package runs the iteration as one jitted program, the port runs it
eagerly; the human-human attention of every forward and backward goes
through K1 and K2 when ``use_pallas_attention`` is set.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..config import Config
from ..env import vector
from ..env.types import EnvState, OUTCOME_TIMEOUT
from ..models import policy as policy_mod
from ..models.gst.st_model import STModel
from ..models.policy_net import init_hidden, obs_to_dict
from ..utils.profiling import span, spanned
from .evaluation import case_generator
from .gae import compute_returns


@dataclasses.dataclass
class TrainState:
    """What one iteration reads and advances (``ppo.py:30-40``). The model
    and the optimizer are updated in place."""
    model: policy_mod.PolicyHead
    optimizer: torch.optim.Adam
    schedule: torch.optim.lr_scheduler.LambdaLR
    env_states: EnvState
    obs: Dict[str, torch.Tensor]      # (N, ...)
    hxs: Dict[str, torch.Tensor]      # recurrent hidden per env
    masks: torch.Tensor               # (N,)
    generator: torch.Generator        # action noise and minibatch order
    ep_return: torch.Tensor           # (N,) running episode reward
    ep_return_env: torch.Tensor       # (N,) same, without GST penalties
    total_steps: int


@dataclasses.dataclass
class RolloutBatch:
    """One rollout (``ppo.py:43-54``)."""
    obs: Dict[str, torch.Tensor]      # (T+1, N, ...)
    hxs0: Dict[str, torch.Tensor]     # hidden at rollout start (N, ...)
    actions: torch.Tensor             # (T, N, 2)
    log_probs: torch.Tensor           # (T, N, 1)
    values: torch.Tensor              # (T+1, N, 1)
    rewards: torch.Tensor             # (T, N)
    masks: torch.Tensor               # (T+1, N)
    bad_masks: torch.Tensor           # (T+1, N)
    done_returns: torch.Tensor        # (T, N) episode return where done, else nan
    done_returns_env: torch.Tensor    # (T, N) same, env reward only (the
                                      # reference Monitor metric)


def make_optimizer(cfg: Config, params) -> Tuple[torch.optim.Adam,
                                                 torch.optim.lr_scheduler.LambdaLR]:
    """Adam(lr, eps) with, under ``use_linear_lr_decay``, the optax linear
    schedule (``ppo.py:57-72``): lr x (1 - k / K) at Adam step k, K =
    num_updates x ppo_epoch x num_mini_batch. Step the schedule after every
    Adam step. Clip the gradients first with :func:`clip_by_global_norm`."""
    p = cfg.ppo
    optimizer = torch.optim.Adam(params, lr=p.lr, eps=p.eps)
    total = (int(p.num_env_steps) // p.num_steps // p.num_processes
             * p.ppo_epoch * p.num_mini_batch)
    if p.use_linear_lr_decay and total > 0:
        def factor(k):
            return 1.0 - min(k, total) / total
    else:
        def factor(k):
            return 1.0
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq_norm: Optional[torch.Tensor] = None):
    """optax.clip_by_global_norm in place: every gradient times
    min(1, max_norm / ||all gradients||). ``sq_norm`` is the squared norm
    when ``grads`` are not all of it (tensor-parallel pieces)."""
    if sq_norm is None:
        sq_norm = sum((g * g).sum() for g in grads)
    norm = torch.sqrt(sq_norm)
    factor = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(factor)


@spanned("ppo.init_train_state")
def init_train_state(cfg: Config, gst_model: Optional[STModel], device,
                     model: Optional[policy_mod.PolicyHead] = None,
                     env_ids: Optional[range] = None) -> TrainState:
    """Reset ``num_processes`` envs, each from its own generator seeded by
    ``ppo.seed`` and its index in the train phase's stream, and build a
    fresh optimizer (``ppo.py:75-98``). ``model`` defaults to
    :func:`policy_mod.init_params` drawn from ``ppo.seed``. ``env_ids``
    keeps only those envs (a data-parallel rank's slice)."""
    p = cfg.ppo
    if env_ids is None:
        env_ids = range(p.num_processes)
    N = len(env_ids)
    gens = [case_generator(p.seed, i, "train") for i in env_ids]
    env_states, obs = vector.vec_reset_with_pretext(cfg, gens, gst_model,
                                                    device)
    if model is None:
        model = policy_mod.init_params(
            cfg, torch.Generator().manual_seed(p.seed), device)
    optimizer, schedule = make_optimizer(cfg, model.parameters())
    generator = torch.Generator(device=device)
    generator.manual_seed(p.seed)
    zeros = torch.zeros(N, device=device)
    return TrainState(
        model=model, optimizer=optimizer, schedule=schedule,
        env_states=env_states, obs=obs_to_dict(obs),
        hxs=init_hidden(cfg, N, device), masks=torch.ones(N, device=device),
        generator=generator, ep_return=zeros, ep_return_env=zeros.clone(),
        total_steps=0)


def spin_coefficient(cfg: Config, total_steps: int, phase: str, device):
    """The unicycle's annealed spin-penalty coefficient for a rollout that
    starts at ``total_steps`` env steps (``ppo.py:106-114``): factor x
    clip(total_steps / warmup, 0, 1), in float32 as a device scalar, when
    ``reward.spin_penalty_warmup_steps`` > 0, the robot is a unicycle and
    the phase is "train"; None (the constant factor) otherwise."""
    r = cfg.reward
    if not (r.spin_penalty_warmup_steps > 0 and phase == "train"
            and cfg.action_space.kinematics == "unicycle"):
        return None
    steps = torch.tensor(float(total_steps), dtype=torch.float32,
                         device=device)
    frac = (steps / r.spin_penalty_warmup_steps).clamp(0.0, 1.0)
    return r.spin_penalty_factor * frac


@spanned("ppo.rollout")
def rollout(cfg: Config, ts: TrainState, gst_model: Optional[STModel],
            phase: str = "train", env_offset: Optional[int] = None
            ) -> Tuple[TrainState, RolloutBatch]:
    """T steps of sampled actions and env steps, then the bootstrap value
    (``ppo.py:101-163``; reference train.py:152-207). The unicycle's spin
    penalty is annealed by :func:`spin_coefficient`, computed once from the
    rollout's first step. ``env_offset``: ``ts`` holds the envs from this
    index of the ``num_processes`` on, and each step's action noise is
    their slice of the draw for all of them."""
    T = cfg.ppo.num_steps
    spin_coef = spin_coefficient(cfg, ts.total_steps, phase, ts.masks.device)
    env_states, obs, hxs, masks = ts.env_states, ts.obs, ts.hxs, ts.masks
    ep_ret, ep_env = ts.ep_return, ts.ep_return_env
    nan = torch.full_like(ep_ret, float("nan"))
    noise_rows = (None if env_offset is None
                  else (env_offset, cfg.ppo.num_processes))
    steps = []
    for _ in range(T):
        value, action, log_prob, hxs_new = policy_mod.act(
            ts.model, obs, hxs, masks, deterministic=False,
            generator=ts.generator, noise_rows=noise_rows)
        env_states, obs_next, rew, done, info, penalty = vector.vec_step(
            cfg, env_states, action, phase, gst_model, spin_coef)
        ep_ret = ep_ret + rew
        ep_env = ep_env + rew - penalty
        steps.append(dict(
            obs=obs, value=value, action=action, log_prob=log_prob, rew=rew,
            masks=masks, done_ret=torch.where(done, ep_ret, nan),
            done_ret_env=torch.where(done, ep_env, nan),
            bad=(info.outcome != OUTCOME_TIMEOUT).float()))
        ep_ret = torch.where(done, 0.0, ep_ret)
        ep_env = torch.where(done, 0.0, ep_env)
        obs, hxs, masks = obs_to_dict(obs_next), hxs_new, 1.0 - done.float()

    last_value = policy_mod.get_value(ts.model, obs, hxs, masks)

    def stack(key, last=None):
        seq = [s[key] for s in steps]
        return torch.stack(seq if last is None else seq + [last])

    batch = RolloutBatch(
        obs={k: torch.stack([s["obs"][k] for s in steps] + [obs[k]])
             for k in obs},
        hxs0=ts.hxs, actions=stack("action"), log_probs=stack("log_prob"),
        values=stack("value", last_value), rewards=stack("rew"),
        masks=stack("masks", masks),
        bad_masks=torch.cat([torch.ones_like(masks)[None], stack("bad")]),
        done_returns=stack("done_ret"), done_returns_env=stack("done_ret_env"))
    ts = dataclasses.replace(
        ts, env_states=env_states, obs=obs, hxs=hxs, masks=masks,
        ep_return=ep_ret, ep_return_env=ep_env,
        total_steps=ts.total_steps + T * cfg.ppo.num_processes)
    return ts, batch


@spanned("ppo.gae")
def advantages(cfg: Config, batch: RolloutBatch):
    """(returns (T, N), normalised advantages (T, N)) (``ppo.py:174-181``):
    advantages over the whole batch, normalised with std(ddof=1) as torch's
    ``.std()`` does."""
    p = cfg.ppo
    returns = compute_returns(batch.rewards, batch.values[:, :, 0],
                              batch.masks, batch.bad_masks, p.gamma,
                              p.gae_lambda, p.use_gae,
                              p.use_proper_time_limits)
    adv = returns - batch.values[:-1, :, 0]
    return returns, (adv - adv.mean()) / (adv.std() + 1e-5)


@spanned("ppo.loss")
def ppo_loss(cfg: Config, model: policy_mod.PolicyHead, batch: RolloutBatch,
             returns, adv_n, idx):
    """The minibatch loss over envs ``idx`` (``ppo.py:187-215``): clipped
    surrogate, (clipped) value loss and entropy bonus. Returns (total,
    (value_loss, action_loss, entropy))."""
    p = cfg.ppo
    obs_mb = {k: v[:-1, idx] for k, v in batch.obs.items()}
    hxs_mb = {k: v[idx] for k, v in batch.hxs0.items()}
    values, log_probs, entropy = policy_mod.evaluate_actions(
        model, obs_mb, hxs_mb, batch.masks[:-1, idx], batch.actions[:, idx])
    values = values[:, :, 0]
    vpred_old = batch.values[:-1, idx, 0]
    ret_mb, adv_mb = returns[:, idx], adv_n[:, idx]
    ratio = torch.exp(log_probs[:, :, 0] - batch.log_probs[:, idx, 0])
    surr1 = ratio * adv_mb
    surr2 = torch.clamp(ratio, 1.0 - p.clip_param, 1.0 + p.clip_param) * adv_mb
    action_loss = -torch.minimum(surr1, surr2).mean()
    if p.use_clipped_value_loss:
        v_clipped = vpred_old + torch.clamp(values - vpred_old,
                                            -p.clip_param, p.clip_param)
        value_loss = 0.5 * torch.maximum((values - ret_mb) ** 2,
                                         (v_clipped - ret_mb) ** 2).mean()
    else:
        value_loss = 0.5 * ((ret_mb - values) ** 2).mean()
    total = (value_loss * p.value_loss_coef + action_loss
             - entropy * p.entropy_coef)
    return total, (value_loss, action_loss, entropy)


@spanned("ppo.update")
def ppo_update(cfg: Config, model: policy_mod.PolicyHead,
               optimizer: torch.optim.Adam,
               schedule: torch.optim.lr_scheduler.LambdaLR,
               batch: RolloutBatch,
               generator: Optional[torch.Generator] = None,
               perms: Optional[torch.Tensor] = None,
               mesh=None) -> Dict[str, torch.Tensor]:
    """``ppo_epoch`` x ``num_mini_batch`` clipped-PPO Adam steps
    (``ppo.py:166-242``). Each epoch visits the envs in the order of one row
    of ``perms`` (ppo_epoch, N), drawn from ``generator`` when not given.
    Returns the mean value loss, action loss and entropy over the steps.

    With a ``parallel.mesh.Mesh``, ``batch`` is the whole batch on every
    rank: each dp index takes its part of every minibatch, weighs its loss
    by its share, and the gradients (and metrics) are summed over dp, so
    the step is the one of the whole minibatch; the clip reads the norm of
    the whole gradient, each tp piece counted once."""
    p = cfg.ppo
    N = batch.rewards.shape[1]
    n_per_batch = N // p.num_mini_batch
    returns, adv_n = advantages(cfg, batch)
    if perms is None:
        perms = torch.stack([
            torch.randperm(N, generator=generator, device=generator.device)
            for _ in range(p.ppo_epoch)])
    perms = perms.to(batch.rewards.device)
    params = list(model.parameters())
    n_updates = p.ppo_epoch * p.num_mini_batch
    acc = torch.zeros(3, device=batch.rewards.device)
    for k in range(n_updates):
        epoch, mb = divmod(k, p.num_mini_batch)
        idx = perms[epoch, mb * n_per_batch:(mb + 1) * n_per_batch]
        share = 1.0
        if mesh is not None:
            part = idx.tensor_split(mesh.dp)[mesh.dp_rank]
            if not len(part):
                raise ValueError(f"a minibatch of {len(idx)} envs does not "
                                 f"cover dp = {mesh.dp}")
            share, idx = len(part) / len(idx), part
        total, aux = ppo_loss(cfg, model, batch, returns, adv_n, idx)
        optimizer.zero_grad()
        aux, sq_norm = torch.stack(aux).detach(), None
        if mesh is None:
            with span("ppo.backward"):
                total.backward()
        else:
            with span("ppo.backward"):
                (total * share).backward()
            aux = aux * share
            mesh.sum_dp_([q.grad for q in params] + [aux])
            sq_norm = mesh.grad_sq_norm(params)
        with span("ppo.optimizer"):
            clip_by_global_norm([q.grad for q in params], p.max_grad_norm,
                                sq_norm)
            optimizer.step()
            schedule.step()
        acc += aux
    acc /= n_updates
    return {"value_loss": acc[0], "action_loss": acc[1], "dist_entropy": acc[2]}


def batch_metrics(batch: RolloutBatch) -> Dict[str, torch.Tensor]:
    """The rollout's metrics (``ppo.py:250-259``): the finished episodes'
    returns, the mean reward, and their count and sums (one scalar each,
    which a data-parallel run logs from)."""
    return {"done_returns": batch.done_returns,
            "done_returns_env": batch.done_returns_env,
            "reward_mean": batch.rewards.mean(),
            "done_count": (~torch.isnan(batch.done_returns)).sum(),
            "done_sum": torch.nansum(batch.done_returns),
            "done_sum_env": torch.nansum(batch.done_returns_env)}


def train_iteration(cfg: Config, ts: TrainState, gst_model: Optional[STModel]
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One PPO iteration: rollout, GAE and the optimization
    (``ppo.py:245-260``). Metrics stay on the device."""
    ts, batch = rollout(cfg, ts, gst_model)
    metrics = ppo_update(cfg, ts.model, ts.optimizer, ts.schedule, batch,
                         ts.generator)
    metrics.update(batch_metrics(batch))
    return ts, metrics
