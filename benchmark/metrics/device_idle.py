"""The device's idle share of the traced slice: one minus the union of the
device operations' intervals over the slice's host-clock length."""


def read(r):
    t = r.trace
    if t is None or not t.busy_s or not r.trace_window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / r.trace_window_s)
