"""The comparison that decides `correct` fails a broken program: each
fault the cells can have is planted under the timed path of a tiny run on
the CPU (every step of a run but the look for a card), and `correct`
comes out false. The control (the reference in bfloat16 in the
program's place) fails too. Without a card the command prints no result
and exits 1, and so it does in a directory that holds only the
benchmark."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.faults import FAULTS
from perfbench.tests import tiny

SEED = "3000000011"
# the tiny cell each fault is planted in
FAULT_CELLS = {"answer_altered": "tiny-spheres2-frame",
               "half_frame": "tiny-dragon-split",
               "state_unchanged": "tiny-spheres2-train",
               "half_batch_loss": "tiny-spheres2-train"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(root, cell):
    rc, res, err = tiny.run_cell(root, ["--workload", cell, "--seed", SEED,
                                        "--seconds", "1", "--trace", "0"])
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(root, fault):
    rc, res, err = tiny.run_cell(
        root, ["--workload", FAULT_CELLS[fault], "--seed", SEED,
               "--seconds", "1", "--trace", "0"],
        f"from perfbench import faults\nfaults.plant({fault!r})")
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_is_not_correct(root, cell):
    code = ("from pathlib import Path\nfrom perfbench import control\n"
            f"nums, failed = control.control(Path('.').resolve(), {cell!r}, "
            f"{SEED}, 'torch')\nprint(failed)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=tiny.clean_env(), capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.strip().splitlines()[-1]) >= 1


def _command(cwd):
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    return subprocess.run(
        bench["command"] + ["--workload", bench["workloads"][0]["name"],
                            "--seed", SEED, "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=tiny.clean_env(), capture_output=True, text=True,
        timeout=300)


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = _command(tiny.REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = tiny.clean_env()
    env.pop("PYTHONPATH")
    p = subprocess.run(json.loads((tmp_path / "BENCHMARK.json").read_text())
                       ["command"] + ["--workload", "spheres2-1080p-parity-frame", "--seed", "1",
                                      "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
