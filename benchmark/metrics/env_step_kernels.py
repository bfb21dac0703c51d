"""Device operations launched inside one ``env/crowd_sim.step`` call, from
the profiler trace of the traced slice: the operations whose launch falls
in a ``bench.env_step`` range, over the number of such ranges. A count of
the launch-bound layer's work, which repeats exactly for a seed."""


def read(r):
    t = r.trace
    if t is None or not t.range_calls.get("env_step") \
            or not t.range_ops.get("env_step"):
        return None
    return t.range_ops.get("env_step", 0) / t.range_calls["env_step"]
