"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``) run on the same
inputs.

The reference cannot replay a whole rollout or suite: the port's bfloat16
kernels move its actions by rounding, ORCA's solve is not smooth, and the
trajectories part within steps. So it follows the program step by step
from the program's own recorded state (the env state before a step, with
each env's generator state, and the action taken), and checks the start
(the first reset) by itself. Each check gives one number:

- ``env``: the env step, auto-reset included. The largest absolute gap of
  every float of the next state and observation (m, m/s), and of the
  reward, whose GST penalty is recomputed from the program's own
  predictions (a prediction moved by rounding may cross the collision
  radius; ``gst`` holds the predictions; where no GST runs, the reward
  as the env gave it); plus one for every differing discrete value (done,
  outcome, human count, masks).
- ``gst``: the GST pretext. The root mean square gap of the predicted
  robot-frame positions (m), taken for each env over its predictions in
  the checked steps, and the largest over the envs, so that a fault in one
  env's row is not diluted by the others. (The largest single gap swings
  from seed to seed by the recursive decoder's amplification, and came
  within 2-3x of the control's.) ``gst_pooled``: the same gaps' root
  mean square over every prediction of every env, for a cell whose widest
  env comes within 3x of the control's. Neither is given where the
  configuration runs no GST (``predict_method`` other than ``inferred``).
- ``act``: the policy. The root mean square gap of the value, of the
  recurrent state and of the log-probability of the action taken (sampled
  acts) or of the action (deterministic acts), each taken for each env
  over its rows of the checked acts and the largest over the envs; the
  largest of the three.
- ``loss``, ``grad``, ``update`` (training): the update's first three Adam
  steps on the program's minibatches. Each step's loss (relative gap); the
  first gradient as the optimizer got it, read from Adam's first moment
  after one step; the parameters' change after three. The last two by the
  worst leaf: the gap between the program's norm and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf. ``update`` leaves out the leaves whose reference gradient is under
  a thousandth of the median leaf's (they move by Adam's rounding alone).
  A cell compares the numbers its limits file names.
- ``batch`` (training): the envs missing from or repeated in the first
  epoch's minibatches, over the env count (exact: 0).
- ``accounting`` (suite): the suite's metrics worked out again from every
  step's reward, done, outcome and robot position (largest relative gap).

The same functions run the reference in the program's place at a lower
precision (the control, ``precision``) or with a fault planted, to read
the numbers that set the limits.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import torch

import reference.config as rconfig
import reference.crowd_sim as rsim
import reference.distributions as rdist
import reference.policy as rpolicy
import reference.ppo as rppo
import reference.predictor as rpred
import reference.pretext as rpretext
import reference.types as rtypes
import reference.vector as rvector
from reference import precision
from reference.params import params_tree, tree_to_state_dict

from .port import fold_seed
from .record import snap

PHASE_OFFSET = {"val": 0, "test": 1000, "train": 2000}
FAULTS = ("state_unchanged", "half_batch", "answer_altered")



@dataclasses.dataclass
class Records:
    """What a run hands to the check."""
    kind: str                        # "train", "suite" or "gym"
    config_path: str
    seed: int
    policy_state: Optional[dict]     # seeded weights handed to both sides
    policy_path: Optional[str]       # or the committed weights both read
    gst_path: Optional[str]          # None where the configuration runs no GST
    start: Optional[dict] = None     # the program's first state and obs
    start_seeds: Optional[list] = None   # the first reset's generator seeds
    steps: List[dict] = dataclasses.field(default_factory=list)
    acts: List[dict] = dataclasses.field(default_factory=list)
    update: Optional[object] = None  # record.UpdateTape
    suites: List[dict] = dataclasses.field(default_factory=list)
    suite_results: List[dict] = dataclasses.field(default_factory=list)


# --- building the reference's objects ---------------------------------------

def ref_config(rec: Records):
    cfg = rconfig.config_from_snapshot(rec.config_path)
    return cfg.replace(ppo=dataclasses.replace(cfg.ppo,
                                               seed=fold_seed(rec.seed)))


def _gen(state):
    g = torch.Generator()
    g.set_state(state)
    return g


def _dc(cls, d):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name == "gens":
            v = [_gen(s) for s in v]
        elif f.name == "robot":
            v = _dc(rtypes.RobotState, v)
        elif f.name == "humans":
            v = _dc(rtypes.HumanState, v)
        kw[f.name] = v
    return cls(**kw)


def ref_state(d):
    return _dc(rtypes.EnvState, d)


def _stored(d):
    """A snapped tree as the precision in force keeps state."""
    if isinstance(d, dict):
        return {k: _stored(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_stored(v) for v in d]
    return precision.store(d)


# --- the reference's outputs -------------------------------------------------

def _step(cfg, gst, rec_step: dict, vec: bool, fault: Optional[str]):
    state = ref_state(rec_step["state"])
    action = rec_step["action"]
    robot_policy = rec_step.get("robot_policy", "network")
    if fault == "state_unchanged":
        pre = snap(state)
        return {"state_out": pre, "obs_out": None, "rew": None,
                "unchanged": True}
    st, obs, rew, done, info = rsim.step(cfg, state, action,
                                         rec_step["phase"], robot_policy)
    if vec:
        idx = done.nonzero()[:, 0]
        if idx.numel():
            fresh_s, fresh_o = rsim.reset(
                cfg, [st.gens[i] for i in idx.tolist()], action.device)
            st = rtypes.tree_scatter(idx, fresh_s, st)
            obs = rtypes.tree_scatter(idx, fresh_o, obs)
    if gst is not None:
        st2, obs2, rew2, _, mask = rpretext.pretext_parts(cfg, gst, st, obs,
                                                          rew)
    else:
        st2, obs2, rew2, mask = st, obs, rew, None
    if fault == "answer_altered":
        rew2 = rew2 + 1.0
    return {"state_out": _stored(snap(st2)), "obs_out": _stored(snap(obs2)),
            "rew": precision.store(rew2), "rew_env": rew, "mask": mask,
            "done": done, "outcome": info.outcome}


def _act(model, rec_act: dict, fault: Optional[str]):
    obs = {k: v[None] for k, v in rec_act["obs"].items()}
    value, mean, logstd, h = model(obs, rec_act["hxs"], rec_act["masks"][None])
    value, mean, logstd = value[0], mean[0], logstd[0]
    action = rdist.mode(mean) if rec_act["deterministic"] else rec_act["action"]
    if fault == "answer_altered":
        mean = mean + 0.1
    return {"value": value, "h": h, "action": rdist.mode(mean)
            if rec_act["deterministic"] else action,
            "log_prob": rdist.log_prob(mean, logstd, action)}


def _batch(cfg, rec: Records):
    acts, steps = rec.acts, rec.steps
    last = steps[-1]["obs_out"]
    obs = {k: torch.stack([a["obs"][k] for a in acts] + [last[k]])
           for k in acts[0]["obs"]}
    masks = torch.stack([a["masks"] for a in acts]
                        + [1.0 - steps[-1]["done"].float()])
    bad = torch.stack([torch.ones_like(masks[0])]
                      + [(s["info"]["outcome"] != rtypes.OUTCOME_TIMEOUT)
                         .float() for s in steps])
    actions = torch.stack([a["action"] for a in acts])
    rewards = torch.stack([s["rew"] for s in steps])
    return obs, acts[0]["hxs"], masks, bad, actions, rewards


def _update(cfg, model, rec: Records, fault: Optional[str], steps: int = 3):
    obs, hxs0, masks, bad, actions, rewards = _batch(cfg, rec)
    T = actions.shape[0]
    with torch.no_grad():
        value, mean, logstd, _ = model(obs, hxs0, masks)
        logp = rdist.log_prob(mean[:T], logstd[:T], actions)
    batch = rppo.RolloutBatch(obs=obs, hxs0=hxs0, actions=actions,
                              log_probs=logp, values=value, rewards=rewards,
                              masks=masks, bad_masks=bad)
    returns, adv = rppo.advantages(cfg, batch)
    optimizer, schedule = rppo.make_optimizer(cfg, model.parameters())
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    losses, grads = [], {}
    for k in range(steps):
        idx = rec.update.idx[k]
        if fault == "half_batch":
            idx = idx[: len(idx) // 2]
        total, _ = rppo.ppo_loss(cfg, model, batch, returns, adv, idx)
        optimizer.zero_grad()
        total.backward()
        rppo.clip_by_global_norm([p.grad for p in params],
                                 cfg.ppo.max_grad_norm)
        if k == 0:
            grads = {n: p.grad.detach().clone() for n, p in zip(names, params)}
        if fault != "state_unchanged":
            optimizer.step()
            schedule.step()
        losses.append(float(total.detach()))
    theta = {n: p.detach().clone() for n, p in zip(names, params)}
    return {"losses": losses, "grads": grads, "theta": theta}


def _accounting(cfg, suite: dict, fault: Optional[str]) -> dict:
    """The suite's metrics from its steps, as ``algo/evaluation`` states
    them (done-latched episodes; nav time at the start of the last step)."""
    pos = suite["first_pos"]
    B = pos.shape[0]
    dev = pos.device
    zeros = torch.zeros(B, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    steps = torch.zeros(B, dtype=torch.long, device=dev)
    outcome = torch.zeros(B, dtype=torch.long, device=dev)
    danger = torch.zeros(B, dtype=torch.long, device=dev)
    path, mind, eprew = zeros.clone(), zeros.clone(), zeros.clone()
    last = pos
    for r, done, out, md, p in suite["steps"]:
        if fault == "answer_altered":
            r = r + 1.0
        new = torch.where(alive[:, None], p, last)
        steps += alive.long()
        eprew = precision.store(eprew + torch.where(alive, r, zeros))
        path = precision.store(path + torch.where(
            alive, torch.linalg.norm(new - last, dim=-1), zeros))
        last = new
        dang = alive & (out == rtypes.OUTCOME_DANGER)
        danger += dang.long()
        mind = precision.store(mind + torch.where(dang, md, zeros))
        outcome = torch.where(alive & done, out, outcome)
        alive = alive & ~done
    steps, outcome, path, danger, mind, eprew, alive = (
        t.double().cpu() for t in (steps, outcome, path, danger, mind, eprew,
                                   alive))
    success = outcome == rtypes.OUTCOME_REACH_GOAL
    dt = cfg.env.time_step
    return {
        "success_rate": float(success.double().mean()),
        "collision_rate": float((outcome == rtypes.OUTCOME_COLLISION)
                                .double().mean()),
        "timeout_rate": float(((outcome == rtypes.OUTCOME_TIMEOUT)
                               | (alive > 0)).double().mean()),
        "nav_time": float(((steps - 1) * dt)[success].mean())
        if bool(success.any()) else cfg.env.time_limit,
        "path_length": float(path.mean()),
        "intrusion_ratio": float((danger / steps.clamp_min(1) * 100.0).mean()),
        "min_intrusion_dist": float(mind.sum() / max(float(danger.sum()), 1)),
        "mean_episode_reward": float(eprew.mean()),
        "env_steps": len(suite["steps"]) * B,
    }


def _start(cfg, gst, rec: Records, device):
    """The first reset, from the seeds of its generators, and the pretext
    pass where the GST runs (``vec_reset_with_pretext``: the train rollout,
    the suite and the gym adapter all start so)."""
    gens = [_seeded(s) for s in rec.start_seeds]
    st, obs = rvector.vec_reset_with_pretext(cfg, gens, gst, device)
    return {"state": _stored(snap(st)), "obs": _stored(snap(obs))}


def _seeded(seed: int):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def case_seed(base_seed: int, case_idx: int, phase: str) -> int:
    """The seed of one case's CPU generator in the port's suite and train
    streams: ``(base_seed << 32) + phase offset + index``."""
    return (base_seed << 32) + PHASE_OFFSET[phase] + case_idx


def reference_outputs(rec: Records, device, mode: str = "ref",
                      fault: Optional[str] = None) -> dict:
    """The reference's outputs on the run's recorded inputs, at the
    reference's precision (``mode`` "ref") or the control's ("control"),
    with ``fault`` planted (:data:`FAULTS`) when given."""
    with precision.mode(mode):
        cfg = ref_config(rec)
        gst = (rpred.load_gst(cfg.pred, rec.gst_path, device)
               if rec.gst_path is not None else None)
        model = rpolicy.PolicyHead(cfg).to(device)
        if rec.policy_path is not None:
            model.load_state_dict(tree_to_state_dict(
                params_tree(rec.policy_path)), strict=True)
        else:
            model.load_state_dict(rec.policy_state, strict=True)
        out = {"theta0": {n: p.detach().clone()
                          for n, p in model.named_parameters()}}
        with torch.no_grad():
            if rec.start is not None:
                out["start"] = _start(cfg, gst, rec, device)
            out["steps"] = [_step(cfg, gst, s, rec.kind == "train", fault)
                            for s in rec.steps]
            out["acts"] = [_act(model, a, fault) for a in rec.acts]
            out["accounting"] = [_accounting(cfg, s, fault)
                                 for s in rec.suites]
        if rec.kind == "train":
            out["update"] = _update(cfg, model, rec, fault)
        return out


def _answer(s: dict) -> dict:
    """A recorded step as the program answered it: what the gym adapter
    returned where it returned something, else the step's tensors."""
    ret = s.get("returned")
    return {"state_out": s["state_out"],
            "obs_out": ret["obs"] if ret else s["obs_out"],
            "rew": ret["rew"] if ret else s["rew"],
            "done": ret["done"] if ret else s["done"],
            "outcome": s["info"]["outcome"]}


def program_outputs(rec: Records) -> dict:
    out = {"start": rec.start,
           "steps": [_answer(s) for s in rec.steps],
           "acts": [{"value": a["value"], "h": a["h"],
                     "action": a["action"], "log_prob": a["log_prob"]}
                    for a in rec.acts],
           "accounting": rec.suite_results}
    if rec.kind == "train":
        u = rec.update
        out["update"] = {"losses": u.losses, "grads": u.adam1,
                         "theta": u.theta}
    return out


# --- the numbers -------------------------------------------------------------

def _gap(a, b) -> tuple:
    """(largest float gap, count of differing discrete values) between two
    snapped trees; generators are not compared."""
    if isinstance(a, dict):
        g, n = 0.0, 0
        for k in a:
            if k == "gens" or k not in b:
                continue
            gk, nk = _gap(a[k], b[k])
            g, n = max(g, gk), n + nk
        return g, n
    if isinstance(a, list):
        return 0.0, 0
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape:
            return 0.0, 1 + a.numel()
        if a.is_floating_point():
            both_nan = torch.isnan(a) & torch.isnan(b)
            d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
            return float(d.max()) if d.numel() else 0.0, 0
        return 0.0, int((a != b).sum())
    return 0.0, int(a != b)


def _env_number(cfg, prog: dict, ref: dict, r_step: dict) -> float:
    if prog.get("unchanged"):
        g, n = _gap(prog["state_out"], r_step["state_out"])
        return g + n
    g, n = _gap(prog["state_out"], r_step["state_out"])
    po, ro = prog["obs_out"], r_step["obs_out"]
    mask = r_step["mask"]
    if mask is None:
        # no GST: every float of the observation, and the env's reward
        gk, nk = _gap(po, ro)
        g = max(g, gk, float((prog["rew"] - r_step["rew"]).abs().max()))
        n += nk
    else:
        for k in ("robot_node", "temporal_edges", "visible_masks",
                  "detected_human_num"):
            gk, nk = _gap(po[k], ro[k])
            g, n = max(g, gk), n + nk
        pe, re_ = po["spatial_edges"], ro["spatial_edges"]
        g = max(g, float((pe[..., :2] - re_[..., :2]).abs().max()))
        rest = (pe[..., 2:] - re_[..., 2:]).abs().amax(-1)
        if bool((~mask).any()):
            g = max(g, float(rest[~mask].max()))
        A, K = mask.shape[1], cfg.sim.predict_steps
        rel = pe[..., 2:].reshape(pe.shape[0], A, K, 2)
        pen = rpretext.penalty_of(cfg, rel, mask)
        g = max(g, float((prog["rew"] - (r_step["rew_env"] + pen))
                         .abs().max()))
    n += int((prog["done"] != r_step["done"]).sum())
    n += int((prog["outcome"] != r_step["outcome"]).sum())
    return g + n


class _Rms:
    """Root mean square of gaps gathered over many calls, taken for each
    env (the leading dimension of every gap), and the largest over the
    envs."""

    def __init__(self):
        self.sq, self.n = None, None

    def add(self, d: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """``d``: gaps with the env first; ``mask`` (``d``'s leading
        dimensions): which of them count."""
        d = d.detach().double().cpu()
        if mask is not None:
            m = mask.detach().cpu().to(d.dtype)
            while m.dim() < d.dim():
                m = m.unsqueeze(-1)
            d = torch.where(m > 0, d, torch.zeros_like(d))
            n = m.expand_as(d).reshape(d.shape[0], -1).sum(1)
        else:
            n = torch.full((d.shape[0],), float(d[0].numel()),
                           dtype=d.dtype)
        sq = (d ** 2).reshape(d.shape[0], -1).sum(1)
        if self.sq is None:
            self.sq, self.n = sq, n
        else:
            self.sq, self.n = self.sq + sq, self.n + n

    def value(self) -> float:
        if self.sq is None or not bool((self.n > 0).any()):
            return 0.0
        seen = self.n > 0
        return float(torch.sqrt(self.sq[seen] / self.n[seen]).max())

    def pooled(self) -> float:
        """The root mean square over every gap of every env."""
        if self.sq is None or not bool((self.n > 0).any()):
            return 0.0
        return math.sqrt(float(self.sq.sum()) / float(self.n.sum()))


def _gst_gaps(prog: dict, r_step: dict, acc: _Rms):
    """The predicted robot-frame positions' gaps, where the reference
    predicted."""
    if prog.get("unchanged"):
        return
    d = (prog["obs_out"]["spatial_edges"][..., 2:]
         - r_step["obs_out"]["spatial_edges"][..., 2:])
    acc.add(d, r_step["mask"])


def _act_gaps(prog: dict, ref: dict, deterministic: bool, acc: dict):
    """The value's, the recurrent state's and the action's (deterministic
    acts) or the taken action's log-probability's (sampled acts) gaps."""
    acc["value"].add(prog["value"] - ref["value"])
    for k in ref["h"]:
        acc["h"].add(prog["h"][k] - ref["h"][k])
    key = "action" if deterministic else "log_prob"
    acc[key].add(prog[key] - ref[key])


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               names) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of the leaf and of the median
    leaf."""
    rn = {n: float(ref[n].norm()) for n in names}
    med = statistics.median(rn.values()) if rn else 0.0
    return {n: abs((float(prog[n].norm()) if n in prog else 0.0) - rn[n])
            / max(rn[n], med, 1e-30) for n in names}


def _worst(gaps: Dict[str, float]) -> float:
    return max(gaps.values()) if gaps else 0.0


def numbers(kind: str, cfg, prog: dict, ref: dict, rec: Records,
            details: Optional[dict] = None) -> Dict[str, float]:
    """The cell's compared numbers for ``prog`` (the program's outputs, or
    the reference's at another precision or with a fault) against
    ``ref``; ``details`` gets the worst leaves where given."""
    out = {"env": 0.0}
    if prog.get("start") is not None and ref.get("start") is not None:
        g, n = _gap(prog["start"], ref["start"])
        out["env"] = g + n
    runs_gst = cfg.sim.predict_method == "inferred"
    gst = _Rms()
    for p, r in zip(prog["steps"], ref["steps"]):
        out["env"] = max(out["env"], _env_number(cfg, p, ref, r))
        if runs_gst:
            _gst_gaps(p, r, gst)
    if runs_gst:
        out["gst"], out["gst_pooled"] = gst.value(), gst.pooled()
    if len(prog["steps"]) != len(ref["steps"]):
        out["env"] = math.inf
    act = {k: _Rms() for k in ("value", "h", "action", "log_prob")}
    for p, r, a in zip(prog["acts"], ref["acts"], rec.acts):
        _act_gaps(p, r, a["deterministic"], act)
    out["act"] = max(a.value() for a in act.values())
    if kind == "suite":
        acc = 0.0
        if len(prog["accounting"]) != len(ref["accounting"]):
            acc = math.inf
        for p, r in zip(prog["accounting"], ref["accounting"]):
            for k, rv in r.items():
                acc = max(acc, abs(float(p[k]) - rv) / max(abs(rv), 1e-6))
        out["accounting"] = acc
    if kind == "train":
        pu, ru = prog["update"], ref["update"]
        theta0 = ref["theta0"]
        out["loss"] = max(abs(p - r) / max(abs(r), 1e-12)
                          for p, r in zip(pu["losses"], ru["losses"])) \
            if len(pu["losses"]) == len(ru["losses"]) else math.inf
        names = list(ru["grads"])
        grad_gaps = _leaf_gaps(pu["grads"], ru["grads"], names)
        out["grad"] = _worst(grad_gaps)
        rn = {n: float(ru["grads"][n].norm()) for n in names}
        med = statistics.median(rn.values())
        moving = [n for n in names if rn[n] >= 1e-3 * med]
        delta_p = {n: pu["theta"][n] - theta0[n] for n in moving
                   if n in pu["theta"]}
        delta_r = {n: ru["theta"][n] - theta0[n] for n in moving}
        update_gaps = _leaf_gaps(delta_p, delta_r, moving)
        out["update"] = _worst(update_gaps)
        if details is not None:
            details["grad_leaves"] = sorted(grad_gaps.items(),
                                            key=lambda kv: -kv[1])[:3]
            details["update_leaves"] = sorted(update_gaps.items(),
                                              key=lambda kv: -kv[1])[:3]
            details["moving_leaves"] = f"{len(moving)} of {len(names)}"
        N = cfg.ppo.num_processes
        mbs = rec.update.idx[:cfg.ppo.num_mini_batch]
        seen = torch.cat([m.cpu() for m in mbs]) if mbs else torch.zeros(0)
        uniq = int(torch.unique(seen).numel())
        out["batch"] = ((N - uniq) + (int(seen.numel()) - uniq)) / N
    return out


def run_check(rec: Records, device) -> Dict[str, float]:
    """The program's numbers."""
    ref = reference_outputs(rec, device)
    return numbers(rec.kind, ref_config(rec), program_outputs(rec), ref, rec)


def calibrate(rec: Records, device, faults=()) -> Dict[str, Dict[str, float]]:
    """The program's, the control's and each fault's numbers on one run's
    records: the readings the limits are set from."""
    cfg = ref_config(rec)
    ref = reference_outputs(rec, device)
    details = {}
    res = {"program": numbers(rec.kind, cfg, program_outputs(rec), ref, rec,
                              details),
           "program_details": details,
           "control": numbers(rec.kind, cfg,
                              reference_outputs(rec, device, "control"),
                              ref, rec)}
    for f in faults:
        res[f] = numbers(rec.kind, cfg, reference_outputs(rec, device,
                                                          fault=f), ref, rec)
    return res
