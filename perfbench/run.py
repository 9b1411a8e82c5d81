"""The benchmark's one command: run a cell of BENCHMARK.json on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (`perfbench/configs/<config>.json`: the
scene file, the frame, the semantics and the integrator) and a traffic
mix (`perfbench/traffic/<traffic>.json`: the mode, whose loop is
`perfbench/modes/<mode>.py`, its parameters, the comparison's limits and
what the trace must see). Every metric is a reader of its own,
`perfbench/metrics/<metric>.py`, found by the name BENCHMARK.json gives
it; a cell reports the metrics whose `workloads` list it (or that list
none). So a new configuration, mix or metric is a new file.

A run: set-up (imports, the card, the kernels' build or load, the parse
and scene build, one warm item), then with `--trace 0` a window of
`--seconds` of items back to back, each ending when its result is ready
on the device (the end-to-end metrics), or with `--trace 1` a profiled
window (the per-layer metrics, `busy_s` and `window_s`); then the peak
device memory, the program's state freed, and the comparison of what the
window produced with the plain reference (perfbench/reference/), whose
numbers and limits close standard error and the result line. The result
is the last line of standard output. Without a card, or with fewer cards
than the cell asks for, the run prints no result and exits 1; so does it
when a module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, the path starts at perfbench/; the harness imports from
# the checkout's root
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "skele_raytracer_tpu"}
MASK32 = 0xFFFFFFFF


def load_module(path: Path):
    """A file of perfbench/ as a module, by its path (metric names may
    hold dots)."""
    name = "perfbench_" + "_".join(path.relative_to(ROOT).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def for_cell(entries, cell):
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


class Run:
    """What one run knows: the cell's data, the set-up's spans, the
    window's items and times, the trace, and the plain reference's scene
    (built when first asked for, after the window)."""

    def __init__(self, root: Path, bench: dict, cell: str, seed: int,
                 seconds: float, trace: bool, backend: str):
        work = {w["name"]: w for w in bench["workloads"]}
        if cell not in work:
            raise SystemExit(f"no workload named {cell!r} in BENCHMARK.json")
        self.root, self.cell = root, work[cell]
        cfg_entry = {c["name"]: c for c in bench["configs"]}[
            self.cell["config"]]
        self.config = json.loads((root / cfg_entry["file"]).read_text())
        self.traffic = json.loads((root / "perfbench" / "traffic" / (
            self.cell["traffic"] + ".json")).read_text())
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.backend = backend
        self.device = "cuda" if backend == "cuda" else "cpu"
        self.spans: dict = {}
        self.items, self.item_s, self.window_s = 0, [], 0.0
        self.setup_s = None
        self.tr = None
        self._static = None

    @property
    def scene_text(self) -> str:
        return (self.root / self.config["scene"]).read_text()

    def sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def reference(self, dtype=None):
        """(scene, config) of the plain reference, from the scene text."""
        import torch

        from perfbench.reference import render, scene

        dtype = dtype or torch.float32
        c = self.config
        cfg = render.Config(width=c["width"], height=c["height"],
                            parity=c["semantics"] == "parity",
                            gillum=c["gillum"], depth=c["depth"],
                            shadows=c["shadows"], jsample=c["jsample"])
        sc = scene.build(scene.parse(self.scene_text), cfg.parity, dtype,
                         self.device)
        return sc, cfg

    def static_args(self):
        from perfbench import work

        if self._static is None:
            self._static = work.static_args(*self.reference())
        return self._static


def window(run: Run, mode, state, keep: list, k: int, rng):
    """Items back to back for run.seconds; reservoir-samples k of them
    (drawn from the seed) into `keep`."""
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        out = mode.step(run, state, run.items)
        e = time.perf_counter()
        run.item_s.append(e - s)
        _reservoir(keep, k, run.items, out, rng, mode, run, state)
        run.items += 1
        if e - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0


def _reservoir(keep, k, i, out, rng, mode, run, state):
    """Reservoir sampling: after item i, keep holds k items drawn
    uniformly from those so far, each as `mode.keepsake` makes it."""
    if k <= 0:
        return
    j = i if i < k else rng.randrange(i + 1)
    if j < k:
        item = (i, mode.keepsake(run, state, out))
        if j < len(keep):
            keep[j] = item
        else:
            keep.append(item)


def traced(run: Run, mode, state, keep, k, rng, notes):
    from perfbench import tracing

    spec = run.traffic["trace"]

    def run_items(n):
        for _ in range(n):
            out = mode.step(run, state, run.items)
            _reservoir(keep, k, run.items, out, rng, mode, run, state)
            run.items += 1

    run.tr, msgs = tracing.take(run_items, spec["items"], spec["expect"])
    notes += msgs


def execute(argv, backend="cuda"):
    """One run: returns (exit code, result dict or None). `backend`
    "torch" runs the program's plain versions on the CPU (the CPU tests
    drive every step but the look for a card this way)."""
    import torch

    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # build and kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "perfbench_cache" / sub)
    run = Run(root, bench, a.workload, a.seed, a.seconds, bool(a.trace),
              backend)
    chips = run.cell["chips"]
    if backend == "cuda" and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < chips):
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 1, None

    mode = importlib.import_module("perfbench.modes." + run.traffic["mode"])
    state = mode.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - T_START
    keep, k = [], mode.keep_count(run)
    rng = random.Random(a.seed)
    notes = []
    if run.trace:
        traced(run, mode, state, keep, k, rng, notes)
    else:
        window(run, mode, state, keep, k, rng)
    run.sync()
    peak = (torch.cuda.max_memory_allocated() if run.device == "cuda"
            else 0)
    kept = mode.release(run, state, keep)
    state = keep = None
    if run.device == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    entries = bench["per_layer"] if run.trace else bench["end_to_end"]
    for m in for_cell(entries, a.workload):
        value = load_module(root / "perfbench" / "metrics" /
                            (m["name"] + ".py")).read(run)
        if value is None:
            notes.append(f"{m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t0 = time.perf_counter()
    numbers, failed = mode.check(run, kept)
    notes.append(f"the comparison with the reference took "
                 f"{time.perf_counter() - t0:.1f} s")
    correct = failed == 0 and all(v <= lim for v, lim in numbers.values())
    device = {"platform": "gpu" if run.device == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(0)
                       if run.device == "cuda" else "cpu"),
              "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.items, "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace and run.tr is not None:
        device["busy_s"] = run.tr.busy_s()
        device["window_s"] = run.tr.window_s
        result["breakdown"] = {"device_ops": run.tr.top_ops(),
                               "idle_gaps": run.tr.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in numbers.items()}
    for line in notes:
        print(f"perfbench: {line}", file=sys.stderr)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 1, None
    for n, (v, lim) in numbers.items():
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    return 0, result


def main() -> int:
    rc, result = execute(sys.argv[1:])
    if result is not None:
        sys.stdout.flush()
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
