"""Milliseconds of one lock-step step of the suite: the traced run's window
from its start (the suite's reset included) to the profiler's warm-up,
over the lock-step steps taken in it."""


def read(r):
    t = r.run.tracer
    if t.before_s is None or t.skip < 2:
        return None
    return 1e3 * t.before_s / (t.skip - 1)
