"""The whole step's share of the card's bf16 peak: the model FLOPs of every
row the policy's act, the update's forward and backward (three forwards a
row) and the GST pretext processed in the traced run's window before the
profiler started, from the configuration's widths, over those seconds and
989 TFLOP/s. Recomputation is not counted."""

from harness import work


def read(r):
    rows = r.spans.rows
    flops = (rows.get("act", 0) * r.policy_row_flops
             + 3 * rows.get("update_rows", 0) * r.policy_row_flops
             + rows.get("gst_pretext", 0) * r.gst_env_flops)
    seconds = r.run.tracer.before_s
    if not flops or not seconds:
        return None
    return 100.0 * flops / (seconds * work.MFU_PEAK)
