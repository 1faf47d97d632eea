"""``frame_ms``: the window's length in ms over the frames it completed
(a frame completes when its call has returned and the device is
synchronized; the call that crosses the window's end is counted whole)."""


def read(run):
    if not run.latencies:
        return None
    return 1e3 * run.window_s / run.completed
