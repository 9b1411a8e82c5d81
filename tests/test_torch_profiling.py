"""The port's profiler traces (utils/profiling.py `profiler_trace`, behind
`cli --profile`) on the CPU."""

import json
import os

import torch

from skele_raytracer_tpu_torch.config import RenderConfig
from skele_raytracer_tpu_torch.models.renderer import render
from skele_raytracer_tpu_torch.scene.parser import parse_scene_text
from skele_raytracer_tpu_torch.utils import profiling
from tests.conftest import TEST_SCN


def test_profiler_trace_off_writes_nothing(tmp_path):
    with profiling.profiler_trace(None):
        torch.ones(2).sum()
    assert os.listdir(tmp_path) == []


def test_profiler_trace_holds_the_program_stages(tmp_path):
    """A trace of a CPU render (K1's plain version) holds the program's
    stages as annotations beside PyTorch's ops, each stage once."""
    cfg = RenderConfig(width=8, height=6, use_shadows=True, backend="torch")
    scene = parse_scene_text(TEST_SCN).to_scene(cfg.quirks)
    d = str(tmp_path / "prof")
    with profiling.profiler_trace(d):
        img = render(scene, cfg, 0)
        profiling.sync(img)
    assert torch.equal(img, render(scene, cfg, 0))
    events = json.loads((tmp_path / "prof" / profiling.TRACE_FILE
                         ).read_text())["traceEvents"]
    stages = sorted(e["name"] for e in events
                    if e.get("cat") == "user_annotation")
    assert stages == ["k1.planes", "k1.tables", "launch.k1", "render"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert not any(e.get("args", {}).get("Input Dims") for e in events)
