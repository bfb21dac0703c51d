"""The weights a cell runs with, loaded or drawn by the benchmark and
handed to the port and to the reference alike.

The configuration file's ``benchmark`` group names them: ``policy_weights``
is a committed ``.npz`` (both sides read the file) or ``"seeded"`` (drawn
here on the device from the run's seed, one draw for all leaves, and the
same tensors loaded into both); ``gst_weights`` is a committed ``.npz``,
required where the configuration runs the GST (``sim.predict_method`` is
``inferred``) and absent everywhere else, where no GST is loaded.
"""

from __future__ import annotations

import json
import os

import reference.config as rconfig
import reference.policy as rpolicy

from . import check, port, spec


def load(run, cfg):
    """(the port's policy, the port's GST or None where the configuration
    runs none, the check's Records with the weights filled in) for the
    run's configuration."""
    with open(run.config_path) as f:
        bench = json.load(f)["benchmark"]
    p = run.port
    runs_gst = cfg.sim.predict_method == "inferred"
    if runs_gst != ("gst_weights" in bench):
        raise SystemExit(f"{run.config_path}: gst_weights is required where "
                         f"predict_method is 'inferred' and absent elsewhere "
                         f"(predict_method {cfg.sim.predict_method!r})")
    gst_path, gst = None, None
    if runs_gst:
        gst_path = os.path.join(spec.ROOT, bench["gst_weights"])
        gst = p["predictor"].load_gst(cfg.pred, gst_path, run.device)
    policy_path, policy_state = None, None
    if bench["policy_weights"] == "seeded":
        shapes = rpolicy.PolicyHead(
            rconfig.config_from_snapshot(run.config_path))
        policy_state = port.draw_policy_state(shapes, run.seed, run.device)
        model = p["policy"].PolicyHead(cfg).to(run.device)
        model.load_state_dict(policy_state, strict=True)
    else:
        policy_path = os.path.join(spec.ROOT, bench["policy_weights"])
        model = p["policy"].load_policy(cfg, policy_path, run.device)
    rec = check.Records(kind=run.mix["driver"], config_path=run.config_path,
                        seed=run.seed, policy_state=policy_state,
                        policy_path=policy_path, gst_path=gst_path)
    return model, gst, rec
