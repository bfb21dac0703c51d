"""Seconds of one PPO update (GAE and the ppo_epoch x num_mini_batch Adam
steps): the mean of the synchronised host spans around
``algo/ppo.ppo_update`` in the traced run."""

import statistics


def read(r):
    s = r.spans.seconds.get("update")
    return statistics.fmean(s) if s else None
