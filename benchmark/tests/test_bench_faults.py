"""A whole run of each kind of cell, at a tiny size on the CPU (the look
for a card skipped), with each fault the cell can have planted in the
timed path: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, an answer altered where it is
produced. (Every cell runs on one card, so no exchange between cards can
be left out.) Each comes out not correct, on a number that reads above the
cell's limit and at least three times what the sound port reads at the
same tiny size (the limits are set at the cell's size on the card; the
tiny CPU runs read their own rounding)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from conftest import SRNN, tiny_config, tiny_mix
from harness import port, runner

P = port.import_port()


def _run(cell, tmp_path, root):
    return runner.execute(cell, 2718281828, 1.0, False, torch.device("cpu"),
                          time.perf_counter(),
                          config_path=tiny_config(cell, tmp_path, root),
                          mix_overrides=tiny_mix(cell, root), root=root)


def _humans_stay(monkeypatch):
    step = P["crowd_sim"].step

    def stay(cfg, state, action, phase, robot_policy="network",
             spin_coef=None):
        out = step(cfg, state, action, phase, robot_policy, spin_coef)
        st = dataclasses.replace(out[0], humans=dataclasses.replace(
            out[0].humans, pos=state.humans.pos, vel=state.humans.vel))
        return (st,) + tuple(out[1:])
    monkeypatch.setattr(P["crowd_sim"], "step", stay)


def _adam_moves_nothing(monkeypatch):
    def zero(grads, max_norm, sq_norm=None):
        for g in grads:
            g.zero_()
    monkeypatch.setattr(P["ppo"], "clip_by_global_norm", zero)


def _half_minibatch(monkeypatch):
    loss = P["ppo"].ppo_loss

    def half(cfg, model, batch, returns, adv_n, idx):
        return loss(cfg, model, batch, returns, adv_n, idx[: len(idx) // 2])
    monkeypatch.setattr(P["ppo"], "ppo_loss", half)


def _reward_altered_in_rollout(monkeypatch):
    vec_step = P["vector"].vec_step

    def altered(*args, **kwargs):
        out = vec_step(*args, **kwargs)
        return (out[0], out[1], out[2] + 0.5) + tuple(out[3:])
    monkeypatch.setattr(P["vector"], "vec_step", altered)


def _half_suite(monkeypatch):
    chunk = P["evaluation"]._evaluate_chunk

    def half(*args, **kwargs):
        acc, n = chunk(*args, **kwargs)
        k = max(len(acc[0]) // 2, 1)
        return tuple(a[:k] for a in acc), n
    monkeypatch.setattr(P["evaluation"], "_evaluate_chunk", half)


def _reward_altered_in_pretext(monkeypatch):
    pre = P["pretext"].pretext_process

    def altered(*args):
        st, ob, r, pen = pre(*args)
        return st, ob, r + 0.5, pen
    for mod in (P["pretext"], P["evaluation"], P["gym_adapter"],
                P["vector"]):
        monkeypatch.setattr(mod, "pretext_process", altered)


def _gym_reward_altered(monkeypatch):
    step = P["gym_adapter"].CrowdNavGymEnv.step

    def altered(self, action):
        ob, r, term, trunc, info = step(self, action)
        return ob, r + 0.5, term, trunc, info
    monkeypatch.setattr(P["gym_adapter"].CrowdNavGymEnv, "step", altered)


FAULTS = {
    "flagship-train": {"state_unchanged": _adam_moves_nothing,
                       "half_batch": _half_minibatch,
                       "answer_altered": _reward_altered_in_rollout},
    "config5-train": {"state_unchanged": _adam_moves_nothing,
                      "half_batch": _half_minibatch,
                      "answer_altered": _reward_altered_in_rollout},
    SRNN: {"state_unchanged": _adam_moves_nothing,
           "half_batch": _half_minibatch,
           "answer_altered": _reward_altered_in_rollout},
    "flagship-eval": {"state_unchanged": _humans_stay,
                      "half_batch": _half_suite,
                      "answer_altered": _reward_altered_in_pretext},
    "flagship-gym": {"state_unchanged": _humans_stay,
                     "answer_altered": _gym_reward_altered},
}


_sound = {}


def _sound_numbers(cell, tmp_path, root):
    if cell not in _sound:
        res = _run(cell, tmp_path, root)
        _sound[cell] = {k: c["value"] for k, c in res["checks"].items()}
    return _sound[cell]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in sorted(FAULTS[c])])
def test_fault_is_caught(cell, fault, tmp_path, monkeypatch, all_cells):
    sound = _sound_numbers(cell, tmp_path, all_cells)
    FAULTS[cell][fault](monkeypatch)
    res = _run(cell, tmp_path, all_cells)
    assert not res["correct"], res["checks"]
    caught = [k for k, c in res["checks"].items()
              if c["value"] > c["limit"] and c["value"] > 3 * sound[k]]
    assert caught, (res["checks"], sound)
