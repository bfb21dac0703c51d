"""K2's share of its roofline in the traced slice, as ``k1_roofline``
reads K1's, over the ops launched inside ``bench.k2`` ranges (the backward
runs on autograd's thread, and its launches are matched there)."""

from harness import work


def read(r):
    t = r.trace
    calls = r.spans.calls.get("k2")
    device_s = t.range_time.get("k2") if t is not None else None
    if not calls or not device_s:
        return None
    bound = sum(work.k2_bound_s(rows, a, d, dtype)
                for rows, a, d, dtype in calls)
    return 100.0 * bound / device_s
