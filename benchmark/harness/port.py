"""The system under test: the PyTorch and CUDA port, built from a cell's
configuration file, and the seams through which the benchmark watches it.

The configuration file is a run snapshot (the ``config.json`` a training
run writes) with a ``benchmark`` group beside it, which the port's
``config_from_snapshot`` ignores: the weights of the policy (a committed
``.npz`` or ``"seeded"``: drawn here from the seed) and of the GST.

:func:`wrap` replaces a function of the port by a wrapper in every module of
the port that holds it, so the benchmark's spans and records see every call
whichever module makes it; :func:`unwrap_all` puts the originals back.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import math
import sys
from typing import Callable, List, Tuple

import torch

PORT = "crowdnav_prediction_attngraph_tpu_torch"
# the port's modules the benchmark drives or watches, imported before any
# wrapper is installed so that every binding of a wrapped function exists
MODULES = ("config", "algo.ppo", "algo.evaluation", "env.crowd_sim",
           "env.vector", "env.pretext", "env.gym_adapter", "models.policy",
           "models.policy_net", "models.gst.predictor", "ops.masked_attention",
           "sim2real")


def import_port():
    """{short name: module} of the port (``ppo``, ``evaluation``, ...)."""
    mods = {m: importlib.import_module(f"{PORT}.{m}") for m in MODULES}
    return {m.rsplit(".", 1)[-1]: mod for m, mod in mods.items()}


def build_config(port, config_path: str, seed: int):
    """The port's Config from a configuration file, with the run's seed as
    ``ppo.seed`` (the seed folded into 31 bits, which every generator
    accepts)."""
    cfg = port["config"].config_from_snapshot(config_path)
    return cfg.replace(ppo=dataclasses.replace(cfg.ppo,
                                               seed=fold_seed(seed)))


def fold_seed(seed: int) -> int:
    return int(seed) % (2 ** 31 - 1)


def draw_policy_state(ref_model: torch.nn.Module, seed: int, device
                      ) -> dict:
    """Seeded policy weights on ``device``, in float32, from one draw on a
    generator there: every matrix N(0, 1 / fan_in), every vector 0. The
    names and shapes are the reference model's, which are the port's."""
    sd = ref_model.state_dict()
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(seed))
    total = sum(v.numel() for v in sd.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, v in sd.items():
        n = v.numel()
        if v.dim() == 1:
            out[name] = torch.zeros(v.shape, device=device)
        else:
            # nn.Linear keeps (out, in); the raw matrices keep (in, out)
            fan_in = v.shape[1] if name.endswith(".weight") else v.shape[0]
            out[name] = flat[at:at + n].view(v.shape) / math.sqrt(fan_in)
        at += n
    return out


# --- wrappers ---------------------------------------------------------------

_installed: List[Tuple[object, str, object]] = []


def wrap(func: Callable, make: Callable[[Callable], Callable]) -> Callable:
    """Bind ``make(func)`` wherever a module of the port binds ``func``.
    Returns the wrapper."""
    # the wrapper carries the function's attributes (the port keeps launch
    # counters on its kernels' entry functions)
    wrapper = functools.update_wrapper(make(func), func)
    hit = False
    for name, mod in list(sys.modules.items()):
        if mod is None or name.split(".", 1)[0] != PORT:
            continue
        for attr, val in list(vars(mod).items()):
            if val is func:
                setattr(mod, attr, wrapper)
                _installed.append((mod, attr, func))
                hit = True
    if not hit:
        raise RuntimeError(f"{func.__qualname__} is bound in no module of "
                           f"the port")
    return wrapper


def unwrap_all():
    while _installed:
        mod, attr, func = _installed.pop()
        setattr(mod, attr, func)
