"""What the correctness check reads from the timed path: copies of the
inputs and outputs of chosen calls into the port, taken by wrappers around
the port's functions, and references to every suite step's outcome.

A tape copies the calls whose number (from 1, counted while the tape is
on) is in its ``want`` set: the env state before the step with each env's
generator state, the action, and what the step returned. The reference
later steps from those copies and compares. Copying costs a few device
copies a chosen call; the calls not chosen pass straight through.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set

import torch


def snap(x):
    """A detached copy of a dataclass / dict / list of tensors, as nested
    dicts; a list of generators becomes their states."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: snap(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: snap(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, (list, tuple)):
        return [snap(v) for v in x]
    return x


class StepTape:
    """Env steps. ``mode`` "vec" wraps ``vector.vec_step`` (the train
    rollout: step, auto-reset and GST pretext in one call); "split" wraps
    ``crowd_sim.step`` and the ``pretext_process`` that follows it (the
    suite and the gym adapter). With ``accounting`` every step's reward,
    done, outcome, intrusion distance and robot position are kept (by
    reference: no copy) for the suite's outcome accounting."""

    def __init__(self, mode: str, want: Set[int], accounting: bool = False):
        self.mode, self.want, self.accounting = mode, set(want), accounting
        self.on = True
        self.n = 0
        self.records: List[dict] = []
        self.start: Optional[dict] = None   # the first reset's pretext pass
        self.suites: List[dict] = []
        self._pending: Optional[dict] = None
        self._step_out = None

    def new_suite(self):
        self.suites.append({"first_pos": None, "steps": []})

    # "vec"
    def vec_step(self, func):
        def wrapper(cfg, states, actions, phase, gst_model, spin_coef=None):
            if not self.on:
                return func(cfg, states, actions, phase, gst_model, spin_coef)
            self.n += 1
            rec = None
            if self.n in self.want:
                rec = {"n": self.n, "state": snap(states),
                       "action": snap(actions), "phase": phase}
            out = func(cfg, states, actions, phase, gst_model, spin_coef)
            if rec is not None:
                st, obs, rew, done, info, pen = out
                rec.update(state_out=snap(st), obs_out=snap(obs),
                           rew=snap(rew), done=snap(done), info=snap(info))
                self.records.append(rec)
            return out
        return wrapper

    # "split"
    def step(self, func):
        def wrapper(cfg, state, action, phase, robot_policy="network",
                    spin_coef=None):
            if not self.on:
                return func(cfg, state, action, phase, robot_policy,
                            spin_coef)
            self.n += 1
            rec = None
            if self.n in self.want:     # before the step draws from gens
                rec = {"n": self.n, "state": snap(state),
                       "action": snap(action), "phase": phase,
                       "robot_policy": robot_policy}
            out = func(cfg, state, action, phase, robot_policy, spin_coef)
            self._step_out = out
            if rec is not None:
                rec.update(done=snap(out[3]), info=snap(out[4]))
                self._pending = rec
            return out
        return wrapper

    def pretext(self, func):
        def wrapper(cfg, gst_model, state, obs, rew):
            out = func(cfg, gst_model, state, obs, rew)
            if not self.on:
                return out
            st, ob, r, _ = out
            if self._step_out is None:          # the pass after a reset
                if self.start is None:
                    self.start = {"state": snap(st), "obs": snap(ob)}
                if self.accounting and self.suites:
                    self.suites[-1]["first_pos"] = ob.robot_node[:, :2]
                return out
            _, _, _, done, info = self._step_out
            if self.accounting and self.suites:
                self.suites[-1]["steps"].append(
                    (r, done, info.outcome, info.min_dist,
                     ob.robot_node[:, :2]))
            if self._pending is not None:
                self._pending.update(state_out=snap(st), obs_out=snap(ob),
                                     rew=snap(r))
                self.records.append(self._pending)
                self._pending = None
            self._step_out = None
            return out
        return wrapper


class ActTape:
    """Policy acts: the observation, hidden state and masks the act read,
    and what it returned (value, action, log-probability, hidden)."""

    def __init__(self, want: Set[int]):
        self.want = set(want)
        self.on = True
        self.n = 0
        self.records: List[dict] = []

    def act(self, func):
        def wrapper(model, obs, rnn_h, masks, deterministic=True,
                    generator=None, noise_rows=None):
            out = func(model, obs, rnn_h, masks, deterministic, generator,
                       noise_rows)
            if not self.on:
                return out
            self.n += 1
            if self.n in self.want:
                value, action, log_prob, h = out
                self.records.append({
                    "n": self.n, "obs": snap(dict(obs)), "hxs": snap(rnn_h),
                    "masks": snap(masks), "deterministic": deterministic,
                    "value": snap(value), "action": snap(action),
                    "log_prob": snap(log_prob), "h": snap(h)})
            return out
        return wrapper


class UpdateTape:
    """The first Adam steps of a PPO update: each minibatch's envs and loss
    (from ``ppo.ppo_loss``), the parameters before the update and after
    step ``steps``, and the first step's Adam state (from the optimizer's
    step hooks)."""

    def __init__(self, model: torch.nn.Module, optimizer, steps: int = 3):
        self.model, self.steps = model, steps
        self.on = True
        self.theta0 = {k: v.detach().clone()
                       for k, v in model.state_dict().items()}
        self.losses: List[float] = []
        self.idx: List[torch.Tensor] = []
        self.adam1: Dict[str, torch.Tensor] = {}
        self.theta: Dict[str, torch.Tensor] = {}
        self.n_steps = 0
        self._names = {id(p): n for n, p in model.named_parameters()}
        self._hook = optimizer.register_step_post_hook(self._post)

    def loss(self, func):
        def wrapper(cfg, model, batch, returns, adv_n, idx):
            out = func(cfg, model, batch, returns, adv_n, idx)
            if self.on and len(self.losses) < self.steps:
                self.losses.append(float(out[0].detach()))
                self.idx.append(idx.detach().clone())
            return out
        return wrapper

    def _post(self, optimizer, args, kwargs):
        if not self.on:
            return
        self.n_steps += 1
        if self.n_steps == 1:
            for group in optimizer.param_groups:
                beta1 = group["betas"][0]
                for p in group["params"]:
                    st = optimizer.state.get(p, {})
                    if "exp_avg" in st:
                        self.adam1[self._names[id(p)]] = \
                            st["exp_avg"].detach() / (1.0 - beta1)
        if self.n_steps == self.steps:
            self.theta = {k: v.detach().clone()
                          for k, v in self.model.state_dict().items()}
            self.close()

    def close(self):
        self.on = False
        self._hook.remove()
