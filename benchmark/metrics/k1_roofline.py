"""K1's share of its roofline in the traced slice: the sum over its calls
of the least time the card could take (the larger of the call's bytes over
3.35 TB/s and its FLOPs over the peak of its compute type, from its
shapes) over the device time of the kernels its calls launched (the ops
launched inside ``bench.k1`` ranges)."""

from harness import work


def read(r):
    t = r.trace
    calls = r.spans.calls.get("k1")
    device_s = t.range_time.get("k1") if t is not None else None
    if not calls or not device_s:
        return None
    bound = sum(work.k1_bound_s(rows, a, d, dtype)
                for rows, a, d, dtype in calls)
    return 100.0 * bound / device_s
