"""Median milliseconds of one control step of the single-env loop, over
the traced run's steps before the profiler started."""

import statistics


def read(r):
    s = r.run.stats.get("step_s", [])[: max(r.run.tracer.skip - 1, 0)]
    return statistics.median(s) * 1e3 if s else None
