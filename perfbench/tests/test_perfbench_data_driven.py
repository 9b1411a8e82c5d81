"""A configuration, a traffic mix and a per-layer metric are added as new
files only: in a copy of the benchmark, new files and BENCHMARK.json
entries make a new cell that the command finds by name and runs (on the
CPU, through the program's plain versions), and no file of perfbench/
changes."""

from __future__ import annotations

import hashlib
import json

from perfbench.tests import tiny

NEW_CONFIG = {
    "name": "spheres1-32x24-clean", "scene": "perfbench/scenes/spheres1.scn",
    "source": "upstream scenes/spheres1.scn", "width": 32, "height": 24,
    "semantics": "clean", "gillum": 2, "depth": 2, "shadows": True,
    "jsample": 0, "route": "K1", "assumed": [], "reduced": []}
NEW_TRAFFIC = {"mode": "frame", "render": {},
               "compare": {"frames": 2, "pixels": 64, "value_tol": 1e-4,
                           "limits": {"share_off": 0.01, "mean_gap": 1e-4}},
               "trace": {"items": 2, "expect": {}}}
NEW_METRIC = '''"""frames_seen: frames the window completed (a test metric)."""


def read(run):
    return float(run.items)
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted((root / "perfbench").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_only(tmp_path):
    root = tiny.make_copy(tmp_path)
    before = _digests(root)
    pb = root / "perfbench"
    (pb / "scenes" / "spheres1.scn").write_text(
        (tiny.REPO / "scenes" / "spheres1.scn").read_text())
    (pb / "configs" / "spheres1-32x24-clean.json").write_text(
        json.dumps(NEW_CONFIG))
    (pb / "traffic" / "short_frames.json").write_text(json.dumps(NEW_TRAFFIC))
    (pb / "metrics" / "frames_seen.py").write_text(NEW_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(
        name="spheres1-32x24-clean", source="upstream scenes/spheres1.scn",
        file="perfbench/configs/spheres1-32x24-clean.json", reduced=[],
        why="test"))
    bench["workloads"].append(dict(
        name="spheres1-short", config="spheres1-32x24-clean",
        traffic="short_frames", chips=1, why="test"))
    bench["end_to_end"].append(dict(
        name="frames_seen", unit="frames", better="higher", bound=0.25,
        source="host_clock", workloads=["spheres1-short"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, res, err = tiny.run_cell(root, ["--workload", "spheres1-short",
                                        "--seed", "3000000007",
                                        "--seconds", "1", "--trace", "0"])
    assert rc == 0, err
    assert res["correct"] is True
    assert res["metrics"]["frames_seen"]["value"] == res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "frame_ms", "frames_seen"}
    after = _digests(root)
    assert {k: after[k] for k in before} == before
