"""Milliseconds of one ``env/pretext.pretext_process`` call (the GST
forward and the penalty for every env of the batch): the mean of the
synchronised host spans around it."""

import statistics


def read(r):
    s = r.spans.seconds.get("gst_pretext")
    return statistics.fmean(s) * 1e3 if s else None
