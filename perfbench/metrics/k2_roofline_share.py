"""k2_roofline_share: the path trace gradient's bound (perfbench/work)
over the device time of one launch of K2, its per-block sums
(pathtrace_bwd_kernel) and their reduce together, in % (profiler)."""

from perfbench import work

TAGS = ("pathtrace_bwd_kernel", "reduce_kernel(")


def read(run):
    if run.tr is None:
        return None
    total_s, launches = run.tr.kernel_s(TAGS[0])
    reduce_s, _ = run.tr.kernel_s(TAGS[1])
    if not launches or total_s <= 0:
        return None
    c = run.config
    bound_ms, _ = work.k2_work(run.static_args(),
                               c["width"] * c["height"] * max(
                                   c["jsample"] ** 2, 1))
    return 100.0 * bound_ms / (1e3 * (total_s + reduce_s) / launches)
