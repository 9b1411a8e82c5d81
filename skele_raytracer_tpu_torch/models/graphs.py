"""CUDA graphs of the wavefront's chunks: one chunk's whole path (camera
rays, then `integrate`: every wave's sorts, kernels and shading) captured
once as a `torch.cuda.CUDAGraph` and replayed for every chunk of that
shape.

A chunk is hundreds of small launches (about 1,360 on dragon's split
route at gillum 16), each costing the host microseconds, around a few
milliseconds of device work: run eagerly, the card waits on the host. A
replay issues the same kernels in the same order from one launch.

The graph reads two static device buffers, the chunk's sample ids and the
frame's seed (a 0-d int64 tensor, from which ops/sampling.py takes the
key word), written before each replay by stream-ordered device copies;
its output is cloned after each replay. Nothing waits for the device.

Whether a chunk replays is decided from its inputs (`replays`): CUDA
tensors, no autograd, a chunk of the captured length (a cut last chunk
runs eagerly) and no debug output checks (ops/cuda/_build.OUTPUT_CHECKS).
Graphs are keyed on what a capture bakes in (`ChunkGraphs.key`): the
device, the config, the chunk's length and dtype, the scene (each
tensor's address, shape, strides and dtype, and its structural flags) and
whether the device counters count (utils/profiling.py `walk_counters`).
A sharded frame keys on each card's resident copy of the scene
(parallel/api.py `replicate_scene`), whose addresses stay from frame to
frame. An entry keeps its scene alive, so no memory the graph reads is
reused under it. At most CAPACITY graphs are kept per device, the least
recently used released first. A graph holds the kernels bound when it
was captured: whoever rebinds a kernel library calls `clear` first.

A new key runs its chunk eagerly first (the warm-up: kernels built and
loaded, and the device counters' rows zeroed outside any capture), then
captures it; a traced frame's counting graph is a key of its own, so a
take's first traced frame runs one chunk eagerly and pays one capture.
A device's graphs are captured on one side stream into one memory pool:
their replays are ordered on the caller's stream, one chunk at a time,
and what a graph keeps past its replay is its static buffers and output,
so the rest of its memory is scratch that the next capture reuses. A
capture launches nothing, but the wrappers count their launches
(`COUNTERS["launches"]`), the split waves their route
(`COUNTERS["wavefront.shade"]`) and a traced Whitted frame its frontier's
rows (`RECORDER.frontier_rows`) as they run: those counts are put back,
and each replay adds them. The spans inside a chunk (`wave`,
`whitted.spawn`, `sort`, `launch.*`) open only while it is captured; the
caller's `chunk` span opens around each replay and `launch.graph` around
the replay's launch.
`COUNTERS["wavefront.graph"]` counts chunks: `captures`, `replays`, and
`eager` for every chunk the wavefront ran without a replay (a capture's
warm-up included).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from skele_raytracer_tpu_torch.ops.cuda import _build
from skele_raytracer_tpu_torch.utils import profiling

CAPACITY = 4  # graphs kept per device
_MASK = 0xFFFFFFFF
COUNTS = profiling.COUNTERS["wavefront.graph"]


def replays(device: torch.device, grad: bool, n: int, chunk: int) -> bool:
    """Whether a chunk of n samples on `device` replays a graph: a CUDA
    device, no autograd (`grad`: some scene leaf needs a gradient), the
    captured length `chunk`, and no debug output checks."""
    return (device.type == "cuda" and not grad and n == chunk
            and not _build.OUTPUT_CHECKS)


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
    """A captured chunk: the graph, its static inputs (ids, seed) and
    output, the counts its capture recorded ([(counter dict, name,
    count)]: launches, shaded waves) and the scene it reads."""

    __slots__ = ("graph", "ids", "seed", "out", "launches", "keep")

    def __init__(self, graph, ids, seed, out, launches, keep):
        self.graph, self.ids, self.seed, self.out = graph, ids, seed, out
        self.launches, self.keep = launches, keep


class ChunkGraphs:
    """The captured graphs, by key, least recently used first."""

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
    def key(scene, cfg, ids) -> tuple:
        """A frame's key for chunks shaped as `ids`. Asks for the device
        counters' row, so a recording take zeroes it here, before any
        capture."""
        counting = profiling.walk_counters(ids.device, "k3") is not None
        return (ids.device, cfg, ids.shape[0], ids.dtype, _scene_key(scene),
                counting)

    def run(self, fn, key, scene, cfg, seed, ids):
        """fn(scene, cfg, seed, ids) (radiance [N, 3]) by a replay of its
        graph under `key` (`ChunkGraphs.key`); a new key runs fn eagerly
        and captures it."""
        entry = self.graphs.get(key)
        if entry is None:
            out = fn(scene, cfg, seed, ids)
            COUNTS["eager"] += 1
            self._capture(fn, key, scene, cfg, seed, ids)
            return out
        self.graphs.move_to_end(key)
        with torch.cuda.device(ids.device):
            entry.ids.copy_(ids)
            entry.seed.fill_(int(seed) & _MASK)
            with profiling.span("launch.graph"):
                entry.graph.replay()
            out = entry.out.clone()
        for counts, name, n in entry.launches:
            counts[name] += n
        COUNTS["replays"] += 1
        return out

    def _capture(self, fn, key, scene, cfg, seed, ids):
        """Captures fn on the chunk `ids` and keeps the graph under `key`,
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
        COUNTS["captures"] += 1
        mine = [k for k in self.graphs if k[0] == dev]
        if len(mine) > CAPACITY:
            old = self.graphs.pop(mine[0])
            # a replay of the released graph may still be in flight
            torch.cuda.synchronize(dev)
            del old


CHUNK_GRAPHS = ChunkGraphs()
