"""k1_roofline_share: the whole-frame path trace's bound (perfbench/work,
from the scene's tables and the frame's samples) over the device time of
one launch of K1 (pathtrace_kernel, forward), in %. The kernel's time is
the profiler's, summed over the traced launches."""

from perfbench import work

TAG = "pathtrace_kernel<false"


def read(run):
    if run.tr is None:
        return None
    total_s, launches = run.tr.kernel_s(TAG)
    if not launches or total_s <= 0:
        return None
    c = run.config
    bound_ms, _ = work.k1_work(run.static_args(),
                               c["width"] * c["height"] * max(
                                   c["jsample"] ** 2, 1))
    return 100.0 * bound_ms / (1e3 * total_s / launches)
