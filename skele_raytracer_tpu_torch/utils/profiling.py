"""Observability of the port: one recorder of spans and counters, kept in
memory on the profiler's clock, and `torch.profiler` traces of a run.

* Spans (`span`, `spanned`): the program's stages, each recorded with its
  name, its parent span, its item (the root span it belongs to: a frame,
  a training step) and its start and end in `time.time_ns()`, the clock
  kineto converts its events to: a span lies a few microseconds outside
  its `record_function` twin's event. Spans record only while a profiler
  records
  (`torch.autograd._profiler_enabled()`): off, a span site costs that one
  check. The first span opened after a switch from off to on starts a
  new take and clears the spans of the last one, so after a trace is
  retaken the record holds the good take only. Each span also opens a
  `record_function` of its name, so a `profiler_trace` shows the
  program's stages above its kernels. The record is a ring of
  SPAN_CAPACITY spans.
* Host counters (`COUNTERS`, always on; plain numbers): each kernel
  module's `LAUNCHES` dict of launch counts, under `launches` by the
  module's name (a replayed CUDA graph adds what its capture launched),
  `scene.clusters_s`, the seconds spent in `ops/accel.build_clusters`,
  `wavefront.graph`, the wavefront's chunks by how they ran
  (models/graphs.py): `captures` (graphs captured), `replays` (chunks
  served by a replay) and `eager` (every other chunk), `frame.graph`, the
  same for whole-frame K1 renders on the card (models/renderer.py), and
  `wavefront.shade`, the split route's waves on the card by how their
  hits were shaded (models/integrator.py): `kernel` (the glue kernels G3
  and G4 around K4) or `eager` (the tensor code).
* `k1.records` (`RecordCounts`): what K1's hit records of the last
  training step traced in a take say, per record slot and per light
  kind (ops/cuda/pathtrace.py `record_counts`). The step only keeps a
  reference to its records; the reductions run at the counter's first
  read after the take, so a traced step launches nothing more, and a
  step outside a take not even that.
* Device counters (`walk_counters`, only while spans record and a root
  span of ROOT_SPANS is open, so a kernel timed alone under a profiler
  runs as it does outside one): one int64 row per card of WALK_COUNTS for
  each cluster-walking kernel of WALK_KERNELS (K3, K4, K7:
  csrc/cluster_walk.cuh `count_walk`). A take zeroes the rows with a copy
  from pinned memory (a Memcpy, not a kernel launch); `walk_totals` reads
  them once, after the window.
* `wavefront.whitted` (`FrontierCounts`): the Whitted frontier of the
  frames traced in a take, by depth (models/integrator.py
  `integrate_whitted`, through `count_frontier` under the same gate as
  the device counters): its rows, counted on the host from the
  frontier's shapes, and its live rows and the live rows that shade,
  summed on the device per half of the frontier into FRONTIER_DEPTHS
  rows beside the walk counters (one zeroing copy for both); a depth's
  halves are the live reflection and refraction children of the depth
  above. An untraced frame counts nothing and launches nothing more; the
  device sums are read at the counter's reads, after the take.

The stages recorded, by layer: `render` (the root of a frame), `k1.tables`
and `k1.planes` (K1's host packing), `launch.k1` / `k2` / `k3` / `k4` /
`k7` (a kernel wrapper's checks, operand packing, call and output
checks), `chunk`, `wave` (its bounce or depth in `arg`), `whitted.spawn`
(the Whitted frontier's children at a depth, in `arg`) and `sort` (the
wavefront glue), `train.step` (the root of a step), `train.loss`,
`train.backward`, `train.mask` and `train.update` (the trainer). Where
a wavefront chunk replays a CUDA graph, the spans inside it (`wave`,
`whitted.spawn`, `sort`, `launch.k3` / `k4` / `k7`) open only while the
graph is captured; `chunk` opens around each replay and `launch.graph`
around the replay's launch. Where a K1 frame replays one, `k1.tables`,
`k1.planes` and the kernel wrapper's `launch.k1` open only while it is
captured; the replay's launch opens `launch.graph` and, inside it,
`launch.k1` (it launches K1 once).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import deque
from collections.abc import Mapping
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten

TRACE_FILE = "trace.json"  # what `profiler_trace(dir)` writes under dir
SPAN_CAPACITY = 1 << 20  # spans the record keeps, the newest
ROOT_SPANS = ("render", "train.step")  # the items the device counters count
WALK_KERNELS = ("k3", "k4", "k7")
WALK_COUNTS = ("rays", "live", "pairs")
WALK_ROW = len(WALK_KERNELS) * len(WALK_COUNTS)  # int64s per card
FRONTIER_DEPTHS = 32  # depths of the Whitted frontier that are counted
# per depth: its live rows and its live rows that shade, each in the
# frontier's two halves (`count_frontier`)
FRONTIER_ROW = FRONTIER_DEPTHS * 2 * 2  # int64s per card

_enabled = torch.autograd._profiler_enabled


class Span:
    """One recorded stage: name, its id and its parent's and item's ids
    (None for a root; a root is its own item), start and end in ns of
    `time.time_ns()` (end None while open), and `arg` (a wave's bounce or
    depth, else None)."""

    __slots__ = ("name", "id", "parent", "item", "start_ns", "end_ns", "arg")

    def __init__(self, name, id, parent, item, start_ns, end_ns=None,
                 arg=None):
        self.name, self.id, self.parent, self.item = name, id, parent, item
        self.start_ns, self.end_ns, self.arg = start_ns, end_ns, arg

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"item={self.item}, {self.start_ns}-{self.end_ns})")


class Recorder:
    """The spans of the current take, the open spans' stack (one for the
    process: the stages of a frame or a step run one after another, and
    autograd's device thread runs a backward while the caller waits in
    it), and the device counters' rows, by card."""

    def __init__(self):
        self.spans: deque = deque(maxlen=SPAN_CAPACITY)
        self.stack: list = []
        self.on = False  # whether the last span site saw a profiler
        self.take = 0  # takes started so far
        self.next_id = 0
        # card -> [int64 tensor: the walk row, then the frontier's rows;
        # the take it was zeroed in]
        self.walk: dict = {}
        # the Whitted frontier's rows by depth, and the take they count
        self.frontier_rows = {d: 0 for d in range(FRONTIER_DEPTHS)}
        self.frontier_take = 0

    def open(self, name, arg=None) -> Span:
        if not self.on:
            self.on = True
            self.take += 1
            self.spans.clear()
            self.stack.clear()
        parent = self.stack[-1] if self.stack else None
        s = Span(name, self.next_id, None if parent is None else parent.id,
                 self.next_id if parent is None else parent.item, 0,
                 arg=arg)
        self.next_id += 1
        self.spans.append(s)
        self.stack.append(s)
        s.start_ns = time.time_ns()  # last: the twin's stamp comes next
        return s

    def close(self, s: Span) -> None:
        s.end_ns = time.time_ns()
        if s in self.stack:
            self.stack.remove(s)

    def counter_rows(self, device: torch.device) -> torch.Tensor:
        """This take's device counters on `device`: the walk row, then
        the frontier's rows. The take's first use zeroes them with a copy
        from host memory (pinned for a card: a Memcpy, not a kernel
        launch), and the take's first use on any card the frontier's host
        rows."""
        key = (device.type, device.index)
        if key not in self.walk:
            self.walk[key] = [torch.empty(WALK_ROW + FRONTIER_ROW,
                                          dtype=torch.int64, device=device),
                              0]
        entry = self.walk[key]
        if entry[1] != self.take:
            zeros = torch.zeros(WALK_ROW + FRONTIER_ROW, dtype=torch.int64,
                                pin_memory=device.type == "cuda")
            entry[0].copy_(zeros, non_blocking=True)
            entry[1] = self.take
        if self.frontier_take != self.take:
            # in place: a captured chunk graph adds to this dict
            for d in self.frontier_rows:
                self.frontier_rows[d] = 0
            self.frontier_take = self.take
        return entry[0]

    def walk_row(self, device: torch.device) -> torch.Tensor:
        """This take's walk row on `device` (`counter_rows`)."""
        return self.counter_rows(device)[:WALK_ROW]

    def _rows(self):
        return [t for t, take in self.walk.values() if take == self.take]

    def walk_totals(self) -> Optional[dict]:
        """{kernel: {count: total over the cards}} of this take's device
        counters, or None when no kernel counted in it."""
        rows = [t[:WALK_ROW] for t in self._rows()]
        if not rows:
            return None
        sums = [sum(col) for col in zip(*(t.tolist() for t in rows))]
        n = len(WALK_COUNTS)
        return {k: dict(zip(WALK_COUNTS, sums[i * n:(i + 1) * n]))
                for i, k in enumerate(WALK_KERNELS)}


RECORDER = Recorder()


class _On:
    __slots__ = ("span", "fn")

    def __init__(self, name, arg):
        # the span's stamps lie right outside the twin's, so it holds it
        self.fn = torch.profiler.record_function(
            name, None if arg is None else str(arg))
        self.span = RECORDER.open(name, arg)
        self.fn.__enter__()

    def __enter__(self):
        return self.span

    def __exit__(self, *exc):
        self.fn.__exit__(*exc)
        RECORDER.close(self.span)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, arg=None):
    """A context for the stage `name` (`arg`: a number it carries, such as
    a wave's bounce): recorded, with its record_function twin, while a
    profiler records; else nothing but the check."""
    if not _enabled():
        RECORDER.on = False
        return _OFF
    return _On(name, arg)


def spanned(name: str):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list:
    """The spans of the current take, in the order they opened."""
    return list(RECORDER.spans)


def counting() -> bool:
    """Whether the device counters count: spans record inside a root
    span of ROOT_SPANS (a frame or a step)."""
    if not _enabled():
        return False
    stack = RECORDER.stack
    return bool(stack) and stack[0].name in ROOT_SPANS


def walk_counters(device: torch.device, kernel: str) -> Optional[int]:
    """The device address of `kernel`'s (of WALK_KERNELS) counter row on
    `device` while the device counters count (`counting`), else None (the
    kernel then counts nothing)."""
    if not counting():
        return None
    row = RECORDER.walk_row(device)
    return row.data_ptr() + row.element_size() * len(WALK_COUNTS) * (
        WALK_KERNELS.index(kernel))


def walk_totals() -> Optional[dict]:
    """The device counters of the current take: {"k3" | "k4" | "k7":
    {"rays", "live", "pairs": int}}, or None when no kernel counted."""
    return RECORDER.walk_totals()


def count_frontier(depth: int, live: torch.Tensor,
                   shades: torch.Tensor) -> None:
    """Adds one depth of one chunk's Whitted frontier to
    `wavefront.whitted` (the caller counts only where `counting`): its
    rows (live's length) on the host; on the device, the live rows (`live`
    [R], 1.0 where the row carries weight) and the live rows that shade
    (`shades` [R] bool), in each half of the frontier (depth 0 is one:
    its primary rays)."""
    if depth >= FRONTIER_DEPTHS:
        return
    base = RECORDER.counter_rows(live.device)
    RECORDER.frontier_rows[depth] += live.shape[0]
    halves = 1 if depth == 0 else 2
    sums = torch.stack([live, live * shades]).view(2, halves, -1).sum(
        2, dtype=torch.int64)
    base[WALK_ROW:].view(FRONTIER_DEPTHS, 2, 2)[depth, :, :halves] += sums


# ---------------------------------------------------------------------------
# Host counters
# ---------------------------------------------------------------------------

class RecordCounts(Mapping):
    """The counter `k1.records`: {"slots": [{"records", "hits"} per record
    slot], "point" / "directional": {"tests", "unshadowed"}} of K1's hit
    records of the last training step traced in a take (empty before
    one). `hold` keeps, per K1 launch with records in that step, a
    function that reduces its records (and so the records); the first
    read after it runs them, sums their counts and lets the records go."""

    def __init__(self):
        self._item = None  # id of the step's root span whose records are held
        self._held: list = []
        self._counts: dict = {}

    def hold(self, reduce: Callable[[], dict]) -> None:
        """Keep `reduce` (records -> counts) while spans record inside a
        `train.step` root span; else nothing."""
        if not _enabled():
            return
        stack = RECORDER.stack
        if not (stack and stack[0].name == "train.step"):
            return
        if self._item != stack[0].id:
            self._item = stack[0].id
            self._held = []
        self._held.append(reduce)

    def _reduce(self) -> dict:
        if self._held:
            parts, self._held = [f() for f in self._held], []
            self._counts = _sum_counts(parts)
        return self._counts

    def __getitem__(self, key):
        return self._reduce()[key]

    def __iter__(self):
        return iter(self._reduce())

    def __len__(self):
        return len(self._reduce())


class FrontierCounts(Mapping):
    """The counter `wavefront.whitted`: {"rows", "live", "shaded",
    "reflected", "refracted": [count by depth]} of the Whitted frontier
    over the frames counted in the current take (`count_frontier`): rows,
    live rows, live rows that shade, and the live reflection and
    refraction children each depth spawned (the halves of the next
    depth's live rows; none below the last), read from the device rows at
    each read; empty when none counted."""

    def _counts(self) -> dict:
        rows = RECORDER.frontier_rows
        n = sum(1 for d in rows if rows[d]) if (
            RECORDER.frontier_take == RECORDER.take) else 0
        if not n:
            return {}
        sums = [0] * FRONTIER_ROW
        for t in RECORDER._rows():
            sums = [a + b for a, b in zip(sums, t[WALK_ROW:].tolist())]
        # per depth: live in each half, then shading in each half
        live = [sums[4 * d:4 * d + 2] for d in range(n)] + [[0, 0]]
        return {"rows": [rows[d] for d in range(n)],
                "live": [sum(live[d]) for d in range(n)],
                "shaded": [sums[4 * d + 2] + sums[4 * d + 3]
                           for d in range(n)],
                "reflected": [live[d + 1][0] for d in range(n)],
                "refracted": [live[d + 1][1] for d in range(n)]}

    def __getitem__(self, key):
        return self._counts()[key]

    def __iter__(self):
        return iter(self._counts())

    def __len__(self):
        return len(self._counts())


def _sum_counts(parts: list) -> dict:
    """The sum of record counts of one step's K1 launches."""
    out = parts[0]
    for p in parts[1:]:
        out = {"slots": [{k: a[k] + b[k] for k in a}
                         for a, b in zip(out["slots"], p["slots"])],
               **{kind: {k: out[kind][k] + p[kind][k] for k in out[kind]}
                  for kind in ("point", "directional")}}
    return out


# `launches`: {kernel module's name: its LAUNCHES dict}; `wavefront.graph`:
# the wavefront's chunks, counted by models/graphs.py; `frame.graph`: the
# whole-frame K1 renders on the card, counted likewise; `wavefront.shade`:
# the split route's waves on the card by how their hits were shaded
# (models/integrator.py); `k1.records`: K1's hit records of a traced
# training step (`RecordCounts`); `wavefront.whitted`: the Whitted
# frontier of the traced frames (`FrontierCounts`)
COUNTERS: dict = {"scene.clusters_s": 0.0, "launches": {},
                  "wavefront.graph": {"captures": 0, "replays": 0,
                                      "eager": 0},
                  "frame.graph": {"captures": 0, "replays": 0, "eager": 0},
                  "wavefront.shade": {"kernel": 0, "eager": 0},
                  "k1.records": RecordCounts(),
                  "wavefront.whitted": FrontierCounts()}


@contextlib.contextmanager
def timed_counter(name: str):
    """Adds the block's seconds to COUNTERS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        COUNTERS[name] += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


def sync(x) -> None:
    """Wait until the device work behind `x` (a tensor, or a list, tuple
    or dict of them) has finished: CUDA tensors synchronize their
    devices; CPU tensors are ready already."""
    for dev in {t.device for t in tree_flatten(x)[0]
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A torch.profiler trace (CPU, and CUDA where a GPU is visible) of the
    block, written as a Chrome trace to log_dir/trace.json: the program's
    stages (spans, as record_function ranges) above the host's ops and the
    device's kernels. A no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
