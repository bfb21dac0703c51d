"""Milliseconds of one ``env/crowd_sim.step`` call (every env of the
batch): the mean of the synchronised host spans around it."""

import statistics


def read(r):
    s = r.spans.seconds.get("env_step")
    return statistics.fmean(s) * 1e3 if s else None
