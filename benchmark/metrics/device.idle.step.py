"""``device.idle.step``: the device's idle share over a traced window of calls:
1 − (union of the device ops' intervals) / (the window's host span).
The host's gaps between calls count as idle."""


def read(run):
    tr = run.tr
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
