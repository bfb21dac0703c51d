"""Seconds of one PPO rollout (T steps of act, env step and GST pretext,
and the bootstrap value): the mean of the synchronised host spans around
``algo/ppo.rollout`` in the traced run."""

import statistics


def read(r):
    s = r.spans.seconds.get("rollout")
    return statistics.fmean(s) if s else None
