"""CUDA graphs of the renderer's work on the card: a wavefront chunk's
whole path (camera rays, then `integrate`: every wave's sorts, kernels and
shading), or a whole-frame K1 render (`pathtrace.pathtrace_ids`: the
tables, the sample planes, K1 and the stack to [N, 3]), captured once as a
`torch.cuda.CUDAGraph` and replayed for every chunk or frame of that
shape.

A chunk is hundreds of small launches (about 1,360 on dragon's split
route at gillum 16), each costing the host microseconds, around a few
milliseconds of device work: run eagerly, the card waits on the host. A
K1 frame is about 50 launches of table and plane packing before its one
kernel, a millisecond of the host's time. A replay issues the same
kernels in the same order from one launch.

The graph reads two static device buffers, the sample ids and the frame's
seed (a 0-d int64 tensor, from which ops/sampling.py and K1 take the key
word when their kernels run), written before each replay by
stream-ordered device copies; its output is cloned after each replay.
Nothing waits for the device.

Whether work replays is decided from its inputs (`replays`): CUDA
tensors, no autograd, no debug output checks
(ops/cuda/_build.OUTPUT_CHECKS) and, for a chunk, the chunk's length (a
cut last chunk runs eagerly). Graphs are keyed on what a capture bakes in
(`ChunkGraphs.frame_key`, `ChunkGraphs.key`): the device, the config,
the ids' length and dtype, the scene (each tensor's address, shape,
strides and dtype, and its structural flags) and, for a chunk, whether
the device counters count (utils/profiling.py `walk_counters`). Each
length of a K1 frame's ids is a key of its own: the equal bands of a
progressive frame share one graph, and its cut last band runs eagerly
the first time and is captured for the next frame. A sharded frame keys
on each card's resident copy of the scene (parallel/api.py
`replicate_scene`), whose addresses stay from frame to frame. An entry
keeps its scene alive, so no memory the graph reads is reused under it.
At most CAPACITY graphs are kept per device, chunks and frames alike,
the least recently used released first. A graph holds the kernels bound
when it was captured: whoever rebinds a kernel library calls `clear`
first.

A new key runs its work eagerly first (the warm-up: kernels built and
loaded, and the device counters' rows zeroed outside any capture), then
captures it; a traced frame's counting chunk graph is a key of its own,
so a take's first traced mesh frame runs one chunk eagerly and pays one
capture. (A K1 frame counts nothing on the device; the profiler sees
the kernels of a graph captured before it started, so a traced K1 frame
replays the untraced frame's graph.) A device's graphs are captured on
one side stream into one memory pool: their replays are ordered on the
caller's stream, one at a time, and what a graph keeps past its replay
is its static buffers and output, so the rest of its memory is scratch
that the next capture reuses. A capture launches nothing, but the
wrappers count their launches (`COUNTERS["launches"]`), the split waves
their route (`COUNTERS["wavefront.shade"]`) and a traced Whitted frame
its frontier's rows (`RECORDER.frontier_rows`) as they run: those counts
are put back, and each replay adds them. The spans inside the work
(`wave`, `whitted.spawn`, `sort`, `k1.tables`, `k1.planes`, `launch.*`)
open only while it is captured; a replay's launch opens `launch.graph`,
and a K1 frame's also `launch.k1` inside it, so that every K1 that runs
has its `launch.k1` span (perfbench's `k1_lead_ms` pairs them). The
caller's `chunk` span opens around each chunk's replay.
`COUNTERS["wavefront.graph"]` counts chunks and `COUNTERS["frame.graph"]`
whole K1 frames on the card (`Kind`): `captures`, `replays`, and `eager`
for every chunk or frame that ran without a replay (a capture's warm-up
included).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Optional

import torch

from skele_raytracer_tpu_torch.ops.cuda import _build
from skele_raytracer_tpu_torch.utils import profiling

CAPACITY = 4  # graphs kept per device
_MASK = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, eq=False)
class Kind:
    """A kind of graph: the counter of its work (`captures`, `replays`,
    `eager`) and the spans a replay's launch opens, outermost first."""

    counts: dict
    launch: tuple


CHUNK = Kind(profiling.COUNTERS["wavefront.graph"], ("launch.graph",))
FRAME = Kind(profiling.COUNTERS["frame.graph"], ("launch.graph", "launch.k1"))
COUNTS = CHUNK.counts


def replays(device: torch.device, grad: bool, n: int,
            chunk: Optional[int] = None) -> bool:
    """Whether n samples on `device` replay a graph: a CUDA device, no
    autograd (`grad`: some scene leaf needs a gradient), no debug output
    checks and, for a wavefront chunk, the captured length `chunk` (a K1
    frame's key holds its length)."""
    return (device.type == "cuda" and not grad
            and (chunk is None or n == chunk) and not _build.OUTPUT_CHECKS)


def _scene_key(obj) -> tuple:
    """What a capture bakes in of a scene: each tensor leaf's address,
    shape, strides and dtype, and every other field's value, depth
    first."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append((v.data_ptr(), tuple(v.shape), v.stride(), v.dtype))
        elif dataclasses.is_dataclass(v):
            out.append(_scene_key(v))
        else:
            out.append(v)
    return tuple(out)


class _Graph:
    """A captured chunk or frame: the graph, its static inputs (ids,
    seed) and output, the counts its capture recorded ([(counter dict,
    name, count)]: launches, shaded waves) and the scene it reads."""

    __slots__ = ("graph", "ids", "seed", "out", "launches", "keep")

    def __init__(self, graph, ids, seed, out, launches, keep):
        self.graph, self.ids, self.seed, self.out = graph, ids, seed, out
        self.launches, self.keep = launches, keep


class ChunkGraphs:
    """The captured graphs, chunks' and K1 frames', by key, least recently
    used first."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()
        self.capturing: dict = {}  # device -> (side stream, memory pool)

    def clear(self):
        """Releases every graph, and with them their memory pools: a pool
        that no graph holds any more cannot be captured into again, so the
        next capture on a device opens a new one."""
        if self.graphs:
            torch.cuda.synchronize()
        self.graphs.clear()
        self.capturing.clear()

    @staticmethod
    def frame_key(scene, cfg, ids) -> tuple:
        """A whole K1 frame's key for ids shaped as `ids`."""
        return (ids.device, cfg, ids.shape[0], ids.dtype, _scene_key(scene))

    @staticmethod
    def key(scene, cfg, ids) -> tuple:
        """A frame's key for chunks shaped as `ids`. Asks for the device
        counters' row, so a recording take zeroes it here, before any
        capture."""
        counting = profiling.walk_counters(ids.device, "k3") is not None
        return ChunkGraphs.frame_key(scene, cfg, ids) + (counting,)

    def run(self, kind: Kind, fn, key, scene, cfg, seed, ids):
        """fn(scene, cfg, seed, ids) (radiance [N, 3]) by a replay of its
        graph under `key`; a new key runs fn eagerly and captures it.
        Counted in `kind.counts`."""
        entry = self.graphs.get(key)
        if entry is None:
            out = fn(scene, cfg, seed, ids)
            kind.counts["eager"] += 1
            self._capture(kind, fn, key, scene, cfg, seed, ids)
            return out
        self.graphs.move_to_end(key)
        with torch.cuda.device(ids.device):
            entry.ids.copy_(ids)
            entry.seed.fill_(int(seed) & _MASK)
            with contextlib.ExitStack() as launch:
                for name in kind.launch:
                    launch.enter_context(profiling.span(name))
                entry.graph.replay()
            out = entry.out.clone()
        for counts, name, n in entry.launches:
            counts[name] += n
        kind.counts["replays"] += 1
        return out

    def _capture(self, kind: Kind, fn, key, scene, cfg, seed, ids):
        """Captures fn on the ids `ids` and keeps the graph under `key`,
        releasing the device's least recently used graph past CAPACITY."""
        dev = ids.device
        counters = (*profiling.COUNTERS["launches"].values(),
                    profiling.COUNTERS["wavefront.shade"],
                    profiling.RECORDER.frontier_rows)
        before = [(c, dict(c)) for c in counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev):
            if dev not in self.capturing:
                self.capturing[dev] = (torch.cuda.Stream(dev),
                                       torch.cuda.graph_pool_handle())
            side, pool = self.capturing[dev]
            static_ids = ids.clone()
            static_seed = torch.full((), int(seed) & _MASK,
                                     dtype=torch.int64, device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(pool)
                    try:
                        out = fn(scene, cfg, static_seed, static_ids)
                    finally:
                        graph.capture_end()
            finally:
                torch.cuda.current_stream(dev).wait_stream(side)
                counted = []
                for counts, was in before:
                    for name, n in counts.items():
                        if n != was.get(name, 0):
                            counted.append((counts, name,
                                            n - was.get(name, 0)))
                            counts[name] = was.get(name, 0)
        self.graphs[key] = _Graph(graph, static_ids, static_seed, out,
                                  counted, scene)
        kind.counts["captures"] += 1
        mine = [k for k in self.graphs if k[0] == dev]
        if len(mine) > CAPACITY:
            old = self.graphs.pop(mine[0])
            # a replay of the released graph may still be in flight
            torch.cuda.synchronize(dev)
            del old


CHUNK_GRAPHS = ChunkGraphs()
