"""Vectorized env with auto-reset and, in the GST env, the pretext pass
(JAX package ``env/vector.py:54-104``; the reference's ShmemVecEnv
workers, shmem_vec_env.py:140-142, and VecPretextNormalize).

The port's env functions already take a leading env axis, so the batch is
the step itself. Auto-reset follows the worker semantics: a done env's
returned observation is its new episode's first observation, while reward
and done refer to the step that ended the episode. Only the done envs are
reset, each from its own generator, and scattered in (the JAX package
resets every env under ``vmap`` and selects, which would double an eager
step).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..config import Config
from ..models.gst.st_model import STModel
from ..utils.profiling import count, span, spanned
from . import crowd_sim
from .pretext import pretext_process
from .types import EnvState, tree_scatter


def vec_reset_with_pretext(cfg: Config, gens: List[torch.Generator],
                           gst_model: Optional[STModel], device):
    """Reset one env per generator, then, in the ``inferred`` env, the
    initial pretext pass (``vector.py:96-103``;
    VecPretextNormalize.reset:85-101)."""
    states, obs = crowd_sim.reset(cfg, gens, device)
    if cfg.sim.predict_method == "inferred":
        zero = torch.zeros(len(gens), device=device)
        states, obs, _, _ = pretext_process(cfg, gst_model, states, obs, zero)
    return states, obs


@spanned("vec.step")
def vec_step(cfg: Config, states: EnvState, actions, phase: str,
             gst_model: Optional[STModel], spin_coef=None):
    """Batched step with auto-reset (``vector.py:54-93``). Returns (states',
    obs', rewards (B,), dones (B,), infos, pretext penalties (B,)); the
    penalty is also inside the rewards and is returned on its own so episode
    returns can leave it out, as the reference's Monitor does. Only the
    ``inferred`` env runs the GST pretext (``gst_model``); elsewhere the
    penalty is 0. ``spin_coef`` goes to ``crowd_sim.step`` (the unicycle's
    annealed spin penalty). A done env's fresh state starts its unicycle
    speed ``desired_velocity`` at 0 again."""
    states, obs, rew, done, info = crowd_sim.step(cfg, states, actions, phase,
                                                  spin_coef=spin_coef)
    with span("vec.auto_reset"):
        count("sync.vec_done")
        idx = done.nonzero()[:, 0]
        count("vec.resets", idx.numel())
        if idx.numel():
            count("sync.vec_reset_ids")
            fresh_states, fresh_obs = crowd_sim.reset(
                cfg, [states.gens[i] for i in idx.tolist()], actions.device)
            states = tree_scatter(idx, fresh_states, states)
            obs = tree_scatter(idx, fresh_obs, obs)
    if cfg.sim.predict_method == "inferred":
        states, obs, rew, penalty = pretext_process(cfg, gst_model, states,
                                                    obs, rew)
    else:
        penalty = torch.zeros_like(rew)
    return states, obs, rew, done, info, penalty
