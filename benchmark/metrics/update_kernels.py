"""Device operations launched inside one ``algo/ppo.ppo_update`` call, from
the profiler trace of the traced slice: the operations whose launch falls
in a ``bench.update`` range, over the number of such ranges. A count of the
launch-bound update's work (GAE, then each minibatch step's unrolled
forward, loss, gradient clipping and Adam), which repeats exactly for a
seed.

Launches are matched to a range on the thread that opened it
(``harness/trace.summarize``). Autograd runs the backward on a device
thread of its own, so the backward's launches are not in the count."""


def read(r):
    t = r.trace
    if t is None or not t.range_calls.get("update") \
            or not t.range_ops.get("update"):
        return None
    return t.range_ops["update"] / t.range_calls["update"]
