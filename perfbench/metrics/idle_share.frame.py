"""idle_share: the share of the traced window in which no operation ran
on the device, in % (1 - the union of the device operations' intervals
over the window's host-clock length; profiler trace)."""


def read(run):
    if run.tr is None or run.tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.tr.busy_s() / run.tr.window_s)
