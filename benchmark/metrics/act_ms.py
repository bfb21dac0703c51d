"""Milliseconds of one ``models/policy.act`` call (the policy's forward
for every env of the batch, K1 included): the mean of the synchronised
host spans around it."""

import statistics


def read(r):
    s = r.spans.seconds.get("act")
    return statistics.fmean(s) * 1e3 if s else None
