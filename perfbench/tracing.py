"""The traced window: a torch.profiler trace of a run of items (frames or
steps), reduced to kernel intervals, the device's busy time and the
breakdown the result line carries.

The profiler runs one warm-up item with tracing on and its events dropped
(a trace can lose the launches at its very start), then the traced items.
Each cell's traffic file names the kernels it must see and how many per
item (`trace.expect`); a trace that holds another count has lost
launches, and is taken again, up to `TRIES` times. A metric that no take
could read is left out of the result line, with the reason on standard
error.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

TRIES = 3


def names_kernel(tag: str, name: str) -> bool:
    """Whether the kernel `name` is `tag`'s: the name holds tag, and a tag
    without template arguments is not a template instance ("x_kernel" is
    not "x_kernel<2>")."""
    i = name.find(tag)
    while i >= 0:
        if "<" in tag or name[i + len(tag):i + len(tag) + 1] != "<":
            return True
        i = name.find(tag, i + 1)
    return False


@dataclass
class Trace:
    """One good take: device operations (name, start s, end s, is a
    kernel), host operations (name, start s, end s), the traced items and
    the host-clock length of their window."""

    items: int
    window_s: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def kernels(self):
        return [d for d in self.device if d[3]]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union
        of the device operations' intervals."""
        total, end = 0.0, None
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def kernel_s(self, tag: str):
        """(total seconds, launches) of the kernels named by `tag`."""
        hit = [e - s for n, s, e, k in self.device if k and names_kernel(tag, n)]
        return sum(hit), len(hit)

    def top_ops(self, n=10):
        by = {}
        for name, s, e, _ in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The n longest gaps between device operations, each named by
        the innermost host operation running at its middle."""
        dev = sorted(self.device, key=lambda d: d[1])
        gaps, end = [], None
        for _, s, e, _ in dev:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[0])
        out = []
        for length, s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            cover = [(he - hs, hn) for hn, hs, he in self.host
                     if hs <= mid <= he]
            out.append([min(cover)[1] if cover else "host: no operation "
                        "recorded", length])
        return out


COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def _span(ev):
    """(start s, end s) of a raw profiler event."""
    if hasattr(ev, "start_ns"):
        s, d = ev.start_ns(), ev.duration_ns()
    else:
        s, d = ev.start_us() * 1e3, ev.duration_us() * 1e3
    return s * 1e-9, (s + d) * 1e-9


def _reduce(prof):
    """(device operations, host operations) from the profiler's raw
    events (building its FunctionEvent tree takes minutes at a mesh
    frame's hundreds of thousands of events). Annotations (the profiler's
    steps) are neither."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        annotation = getattr(ev, "is_user_annotation", None)
        if name.startswith("ProfilerStep") or (annotation and annotation()):
            continue
        s, e = _span(ev)
        if ev.device_type() == cuda:
            device.append((name, s, e, not name.startswith(COPIES)))
        else:
            host.append((name, s, e))
    return device, host


def take(run_items, n_items: int, expect: dict):
    """Trace `run_items(n)` (which runs n items and waits for the device)
    after one warm-up item; returns (Trace or None, messages). A take
    whose kernel counts differ from `expect` (tag -> launches per item)
    is retaken, up to TRIES times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    notes = []
    for attempt in range(1, TRIES + 1):
        window = [0.0]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            run_items(1)
            prof.step()
            t0 = time.perf_counter()
            run_items(n_items)
            window[0] = time.perf_counter() - t0
            prof.step()
        device, host = _reduce(prof)
        tr = Trace(items=n_items, window_s=window[0], device=device,
                   host=host)
        bad = []
        for tag, per in expect.items():
            _, count = tr.kernel_s(tag)
            if count != per * n_items:
                bad.append(f"{count} launches of {tag} where "
                           f"{per * n_items} ran")
        if not bad and tr.device:
            return tr, notes
        notes.append(f"trace {attempt} of {TRIES} lost launches: "
                     + ("; ".join(bad) or "no device operation"))
    return None, notes
