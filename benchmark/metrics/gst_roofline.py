"""The GST call's share of its roofline in the traced slice: the least time
the card could take for the GST's forward in one pretext call, over the
device time of one ``bench.gst_pretext`` range (``gst_device_ms``). The
least time is the larger of its FLOPs over the peak of their compute type
(``flops/gst.py``: float32 for the edge selector, ``pred.matmul_dtype`` for
the node encoder and the LSTM; summed over the two types) and its least
bytes (inputs, Gumbel uniforms, weights, outputs; no intermediates) over
the HBM bandwidth, as ``work.bound_s`` takes it for K1 and K2. The range
also holds the penalty's few ops, so the share errs low."""

import json

from harness import spec, work


def read(r):
    t = r.trace
    if t is None or not t.range_calls.get("gst_pretext") \
            or not t.range_time.get("gst_pretext"):
        return None
    with open(r.run.config_path) as f:
        snapshot = json.load(f)
    gst = spec.load_module("flops", "gst")
    flops = gst.pretext_flops(snapshot)
    if not flops:
        return None
    bound_s = max(sum(n / work.PEAK_FLOPS[dtype]
                      for dtype, n in flops.items()),
                  gst.pretext_bytes(snapshot, spec.ROOT) / work.PEAK_BYTES)
    device_s = t.range_time["gst_pretext"] / t.range_calls["gst_pretext"]
    return 100.0 * bound_s / device_s
