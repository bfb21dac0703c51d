"""Device milliseconds of one ``env/pretext.pretext_process`` call (the GST
forward, one CUDA graph replay on the card, and the penalty): the device
time of the ops launched inside the ``bench.gst_pretext`` ranges of the
traced slice, over the number of such ranges. A graph's kernels carry the
correlation id of its ``cudaGraphLaunch``, so they fall in the range that
launched it."""


def read(r):
    t = r.trace
    if t is None or not t.range_calls.get("gst_pretext") \
            or not t.range_time.get("gst_pretext"):
        return None
    return 1e3 * t.range_time["gst_pretext"] / t.range_calls["gst_pretext"]
