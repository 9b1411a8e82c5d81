"""launches_per_frame: kernels the device ran in the traced window over the items
traced (profiler trace; copies and fills not counted)."""


def read(run):
    if run.tr is None:
        return None
    return len(run.tr.kernels) / run.tr.items
