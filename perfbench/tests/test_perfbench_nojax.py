"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program. Checked in fresh interpreters,
by whole top-level module names (the program's own name begins with the
JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from perfbench.tests.tiny import REPO, clean_env

FORBIDDEN = {"jax", "jaxlib", "flax", "skele_raytracer_tpu"}
PROGRAM = "skele_raytracer_tpu_torch"


def loaded_after(code: str) -> set:
    probe = (f"{code}\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       env=clean_env(), capture_output=True, text=True,
                       timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_no_file_of_the_benchmark_loads_jax():
    files = sorted(p for p in (REPO / "perfbench").rglob("*.py")
                   if "__pycache__" not in p.parts)
    code = ("import perfbench.run as run\n"
            "from pathlib import Path\n"
            f"for f in {[str(f) for f in files]!r}:\n"
            "    run.load_module(Path(f))\n"
            "import perfbench.modes.frame, perfbench.modes.train_step\n"
            "import perfbench.control, perfbench.tracing\n"
            "import skele_raytracer_tpu_torch.models.train\n"
            "import skele_raytracer_tpu_torch.models.renderer\n")
    names = loaded_after(code)
    assert PROGRAM in names  # the probe did load the program
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import perfbench.reference.scene, "
                         "perfbench.reference.render, "
                         "perfbench.reference.train, perfbench.work")
    assert "torch" in names
    assert not names & (FORBIDDEN | {PROGRAM})
