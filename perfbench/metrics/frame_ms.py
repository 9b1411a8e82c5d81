"""frame_ms: the window's wall time over the whole-frame (K1) frames it completed, in
ms (host clock; each item ends in a synchronize, back to back)."""


def read(run):
    return 1e3 * run.window_s / run.items if run.items else None
