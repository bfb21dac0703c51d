"""Policy API of the reference: ``act``, ``get_value`` and
``evaluate_actions`` over the plain network (a frozen copy of the port's
``models/policy.py``). The base is found by the configuration's
``robot.policy`` alone, in ``bases/<robot.policy>.py``: the attention graph
(``selfAttn_merge_srnn``) and DS-RNN (``srnn``) today."""

from __future__ import annotations

import importlib
import math
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from .config import Config
from .params import params_tree, tree_to_state_dict
from . import distributions

# dense layers the JAX package initialises orthogonal(sqrt 2)
# (``policy_net.py:259-311``, ``srnn.py:121-132``)
_ORTH2 = ("robot_linear", "spatial_linear", "spatial_linear_0",
          "spatial_linear_1", "critic_0", "critic_1", "actor_0", "actor_1",
          "critic_linear")
_BASES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bases")
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def base_class(policy: str):
    """The base network of ``robot.policy`` = ``policy``: ``Base`` of
    ``bases/<policy>.py``."""
    if not _NAME.match(policy) or not os.path.exists(
            os.path.join(_BASES_DIR, f"{policy}.py")):
        known = sorted(f[:-3] for f in os.listdir(_BASES_DIR)
                       if f.endswith(".py") and not f.startswith("_"))
        raise ValueError(f"unknown robot policy {policy!r}, expected one of "
                         f"{known}")
    return importlib.import_module(f"{__package__}.bases.{policy}").Base


class PolicyHead(nn.Module):
    """Base network + DiagGaussian action head; submodules ``base`` and
    ``dist`` as in the flax tree. The base is the one ``robot.policy`` names
    (:func:`base_class`)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.base = base_class(cfg.robot.policy)(cfg)
        self.dist = distributions.DiagGaussianParams(
            cfg.network.human_node_output_size, 2)

    def forward(self, obs, rnn_h, masks, use_kernel: Optional[bool] = None):
        """``use_kernel`` (default ``use_pallas_attention``) picks the
        human-human attention branch."""
        if use_kernel is None:
            use_kernel = self.cfg.network.use_pallas_attention
        value, actor_features, h_new = self.base(obs, rnn_h, masks,
                                                 use_kernel)
        mean, logstd = self.dist(actor_features)
        return value, mean, logstd, h_new


def load_policy(cfg: Config, params, device="cuda") -> PolicyHead:
    """A PolicyHead holding ``params`` on ``device``: a flax-style tree (the
    ``params`` of a JAX checkpoint, with or without the top ``'params'``
    level) or the path of a ``.npz`` export."""
    model = PolicyHead(cfg)
    model.load_state_dict(tree_to_state_dict(params_tree(params)), strict=True)
    return model.to(torch.device(device)).eval()


def init_params(cfg: Config, generator: torch.Generator,
                device="cuda") -> PolicyHead:
    """A fresh PolicyHead drawn from ``generator`` (a CPU generator) with the
    JAX package's initializers (``policy.py:55-62``): orthogonal(sqrt 2)
    for the robot/spatial/actor/critic denses, orthogonal(1) for the GRU
    matrices and ``fc_mean``, xavier-uniform for ``mha_in_proj_weight``,
    flax's Dense default (lecun-normal, truncated at 2 sigma) for every
    other kernel, and zeros for every bias and ``logstd``. The streams
    differ from ``jax.random``'s, so only the distributions match."""
    model = PolicyHead(cfg)
    init = nn.init
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, leaf = name.rsplit(".", 1)
            if p.dim() == 1:
                p.zero_()
            elif leaf in ("w_ih", "w_hh") or owner == "dist.fc_mean":
                init.orthogonal_(p, 1.0, generator=generator)
            elif leaf == "mha_in_proj_weight":
                init.xavier_uniform_(p, generator=generator)
            elif owner.rsplit(".", 1)[-1] in _ORTH2:
                init.orthogonal_(p, math.sqrt(2.0), generator=generator)
            else:  # flax lecun_normal: fan_in = in_features = weight.shape[1]
                std = math.sqrt(1.0 / p.shape[1]) / .87962566103423978
                init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                                   generator=generator)
    return model.to(torch.device(device))


def _update_uses_kernel(cfg: Config) -> bool:
    """Whether gradient-path forwards run the kernel branch
    (``policy.py:42-52``): with ``pallas_scope='rollout'`` the kernel is kept
    to inference and the PPO update runs the einsum branch (the same
    parameters)."""
    net = cfg.network
    return net.use_pallas_attention and net.pallas_scope != "rollout"


def _add_time(obs: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v[None] for k, v in obs.items()}


@torch.no_grad()
def act(model: PolicyHead, obs: Mapping[str, torch.Tensor], rnn_h, masks,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        noise_rows: Optional[Tuple[int, int]] = None):
    """Rollout-time forward (``policy.py:65-78``). obs is [N, ...], masks [N].
    Returns (value [N, 1], action [N, 2], log_prob [N, 1], new hidden).
    ``noise_rows`` goes to :func:`distributions.sample`."""
    value, mean, logstd, h_new = model(_add_time(obs), rnn_h, masks[None, :])
    value, mean, logstd = value[0], mean[0], logstd[0]
    if deterministic:
        action = distributions.mode(mean)
    else:
        action = distributions.sample(mean, logstd, generator, noise_rows)
    return value, action, distributions.log_prob(mean, logstd, action), h_new


@torch.no_grad()
def get_value(model: PolicyHead, obs: Mapping[str, torch.Tensor], rnn_h,
              masks):
    value, _, _, _ = model(_add_time(obs), rnn_h, masks[None, :])
    return value[0]


def evaluate_actions(model: PolicyHead, obs: Mapping[str, torch.Tensor],
                     rnn_h, masks, actions):
    """Training-time forward over [T, N, ...] (``policy.py:88-96``),
    differentiable. Returns (values [T, N, 1], log_probs [T, N, 1], the mean
    entropy)."""
    value, mean, logstd, _ = model(obs, rnn_h, masks,
                                   _update_uses_kernel(model.cfg))
    log_probs = distributions.log_prob(mean, logstd, actions)
    entropy = distributions.entropy(logstd).mean()
    return value, log_probs, entropy
