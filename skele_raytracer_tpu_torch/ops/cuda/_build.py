"""Build the hand-written kernels from `csrc/` and load them with ctypes.

Route: `nvcc` compiles the CUDA sources into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), which is
loaded with `ctypes`; pointers and the stream go in as `c_void_p`. The
library lands in `<repo>/build/kernels/`, named by a hash of the sources
and flags, so an edit to any source rebuilds it and an unchanged tree
reuses it. A build writes to a temporary name and renames it into place,
so concurrent processes never load a half-written library.

`-fmad=false` keeps every multiply and add rounding on its own, as in the
plain PyTorch versions the kernels are checked against. Fast math is
never used.

The same header is built for the host with g++ (`build_host`) so the CPU
tests can run the kernel's math without a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]
GXX_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]

# seconds the last build of each library took (0.0 when it was cached),
# and its compiler's messages (ptxas' registers, stack and spills per
# kernel: -Xptxas -v)
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def _key(sources: list[Path], flags: list[str]) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")) + sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(compiler: str, flags: list[str], sources: list[Path],
             name: str) -> Path:
    out = BUILD_DIR / f"{name}_{_key(sources, flags)}.so"
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-I", str(CSRC), "-o", str(tmp),
           *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stderr
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


_loaded: dict[str, ctypes.CDLL] = {}

# Checks run on each kernel's outputs right after its launch: none, except
# under utils/debug.checked, whose view into the kernels this is (ctypes
# calls are invisible to PyTorch's dispatcher).
OUTPUT_CHECKS: list = []


def check_outputs(name: str, *outs) -> None:
    """Run OUTPUT_CHECKS on the outputs of kernel `name`'s launch."""
    for check in OUTPUT_CHECKS:
        check(name, outs)

# The CUDA libraries of the port: name -> sources in csrc/, and the extra
# nvcc flags of those that need them. "culled_sweep" is culled.cu with K4's
# lane sweep (`culled_occluded_lanes`), "intersect_sweep" intersect.cu with
# K6's (`sphere_nearest_hits_lanes`) and "pathtrace_sweep" pathtrace.cu
# with K1's variants (`pathtrace_forward_variant`), used only for
# measurement and tests; "culled_lab" holds the kernel lab's L1-L4
# (ops/cuda/lab.py), which no render path launches; "glue" the wavefront
# glue's sort keys and draws (ops/cuda/glue.py).
CUDA_LIBRARIES = {"pathtrace": ["pathtrace.cu"],
                  "pathtrace_bwd": ["pathtrace_bwd.cu"],
                  "culled": ["culled.cu"], "intersect": ["intersect.cu"],
                  "megakernel": ["megakernel.cu"], "glue": ["glue.cu"],
                  "culled_lab": ["culled_lab.cu"],
                  "culled_sweep": ["culled.cu"],
                  "intersect_sweep": ["intersect.cu"],
                  "pathtrace_sweep": ["pathtrace.cu"]}
LIBRARY_FLAGS = {"culled_sweep": ["-DCULLED_LANE_SWEEP"],
                 "intersect_sweep": ["-DINTERSECT_LANE_SWEEP"],
                 "pathtrace_sweep": ["-DPATHTRACE_SWEEP"]}


def _nvcc_flags(name: str) -> list[str]:
    return NVCC_FLAGS + LIBRARY_FLAGS.get(name, [])


def build_all() -> dict[str, float]:
    """Compile every CUDA library not built yet, one nvcc per library, all
    at once; returns the seconds each compile took (0.0 when cached).
    Loading stays with each kernel module's `build_kernel`."""
    from concurrent.futures import ThreadPoolExecutor

    nvcc = nvcc_path()
    with ThreadPoolExecutor(len(CUDA_LIBRARIES)) as pool:
        jobs = [pool.submit(_compile, nvcc, _nvcc_flags(name),
                            [CSRC / s for s in sources], name)
                for name, sources in CUDA_LIBRARIES.items()]
        for job in jobs:
            job.result()
    return {name: build_seconds[name] for name in CUDA_LIBRARIES}


def build_cuda(name: str) -> Path:
    """Build (if needed) the CUDA library `name` of CUDA_LIBRARIES; returns
    its path."""
    return _compile(nvcc_path(), _nvcc_flags(name),
                    [CSRC / s for s in CUDA_LIBRARIES[name]], name)


def load_cuda(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the CUDA library `name` of
    CUDA_LIBRARIES; cached per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build_cuda(name)))
    return _loaded[name]


def build_host(name: str, sources: list[str]) -> ctypes.CDLL:
    """Build (if needed) and load a host (g++) library from csrc/."""
    key = "host:" + name
    if key not in _loaded:
        so = _compile(shutil.which("g++") or "g++", GXX_FLAGS,
                      [CSRC / s for s in sources], name)
        _loaded[key] = ctypes.CDLL(str(so))
    return _loaded[key]
