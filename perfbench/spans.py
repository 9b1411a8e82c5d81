"""Readers of the program's own record (skele_raytracer_tpu_torch/utils/
profiling.py): its spans, on the profiler's clock, and its counters. A
program without that record (an earlier tree) gives None, so a metric
that reads it is left out of that run's line.

Spans carry `time.time_ns()` stamps; the trace's device operations carry
kineto's, in seconds of the same clock (perfbench/tracing.py `_span`).
"""

from __future__ import annotations

import bisect
import sys


def _profiling():
    try:
        from skele_raytracer_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def spans():
    """The spans of the program's last take, or None."""
    prof = _profiling()
    fn = getattr(prof, "spans", None)
    return fn() if fn is not None else None


def counter(name: str):
    """A host counter of the program (`COUNTERS[name]`), or None."""
    return getattr(_profiling(), "COUNTERS", {}).get(name)


def walk_totals():
    """The program's device counters of its last take: {kernel: {"rays",
    "live", "pairs"}}, or None."""
    fn = getattr(_profiling(), "walk_totals", None)
    return fn() if fn is not None else None


def roots(record, name: str):
    return [s for s in record if s.parent is None and s.name == name
            and s.end_ns is not None]


def lead_ms(run, root: str, tag: str, launch: str = "launch.k1",
            family: str = "pathtrace_kernel<"):
    """Mean over the traced items' `root` spans of the device start of the
    first kernel named by `tag` that starts after the span opens (and
    before the next item's opens), minus the span's start, in ms; None
    without spans or a trace. Also None, with a note on standard error,
    where the trace and the spans do not share a clock: where some kernel
    of `family` (every kernel the `launch` spans launch, one each) starts
    before the span that launched it opens, or where their counts differ,
    so that no kernel can be paired with its span."""
    from perfbench.tracing import names_kernel

    record = spans()
    if not record or run.tr is None:
        return None
    launched = sorted(s.start_ns * 1e-9 for s in record if s.name == launch)
    ran = sorted(s for n, s, _, k in run.tr.device
                 if k and names_kernel(family, n))
    early = sum(k < s for s, k in zip(launched, ran))
    if len(launched) != len(ran) or early:
        print(f"perfbench: {root} lead: {len(ran)} {family} kernels against "
              f"{len(launched)} {launch} spans, {early} starting before "
              f"their span: the spans and the trace do not share a clock "
              f"in this take", file=sys.stderr)
        return None
    starts = sorted(s for n, s, _, k in run.tr.device
                    if k and names_kernel(tag, n))
    opens = sorted(r.start_ns * 1e-9 for r in roots(record, root))
    leads = []
    for t0, t1 in zip(opens, opens[1:] + [float("inf")]):
        i = bisect.bisect_left(starts, t0)
        if i < len(starts) and starts[i] < t1:
            leads.append(starts[i] - t0)
    return 1e3 * sum(leads) / len(leads) if leads else None


def glue_ms(run):
    """Mean over the traced frames' `render` spans of the span's length
    minus the time its `sort` and `launch.*` descendants cover, in ms."""
    record = spans()
    if not record or run.tr is None:
        return None
    frames = roots(record, "render")
    kept = {}
    for s in record:
        if s.end_ns is not None and (s.name == "sort"
                                     or s.name.startswith("launch.")):
            kept.setdefault(s.item, []).append((s.start_ns, s.end_ns))
    glue = []
    for r in frames:
        covered, end = 0, None
        for s, e in sorted(kept.get(r.id, [])):
            if end is None or s > end:
                covered += e - s
                end = e
            elif e > end:
                covered += e - end
                end = e
        glue.append((r.end_ns - r.start_ns) - covered)
    return 1e-6 * sum(glue) / len(glue) if glue else None


def walk_ratio(kernel: str, num: str, den: str, scale: float = 1.0):
    """scale x Σ num ÷ Σ den of `kernel`'s device counters, or None."""
    totals = walk_totals()
    if not totals or not totals[kernel][den]:
        return None
    return scale * totals[kernel][num] / totals[kernel][den]
