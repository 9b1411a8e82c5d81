"""The split walk of the kernel lab's L1 `lab_v6`, L2 `lab_v5`, L6
`lab_presplit` and L4 `lab_probe` at its loop stage against the JAX
package's TPU kernels (tools/lab_v5.py `launch_v6`, `launch_v5`;
tools/kernel_lab.py `launch_presplit`; tools/lab_probe.py `launch_probe`),
which run here in TPU interpret mode (`pltpu.force_tpu_interpret_mode()`,
as tests/test_torch_lab.py runs them), on tests/test_torch_lab_split.py's
`lab_case` (512 rays in 2 tiles, a seeded 200-triangle mesh in 4 clusters
of 64, 30% dead rays).

The port's answer is the plain version walked over group ranges, one range
per work item of 1 or 2 groups, merged by the host build's keys
(lab_math_host.cpp `lab_key_min_host`): what the split walk's kernels
compute. Against the JAX kernel, on the live rays: hit flags and indices
bitwise; t within T_REL relative, since the TPU kernel sums each
numerator in XLA's order (4 ulp at most on this batch, 2.9e-7 relative),
not in csrc/mesh_math.cuh's; L6's bf16x3 sums its three products' exact
bf16 terms in another order too.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from skele_raytracer_tpu_torch.ops import accel
from skele_raytracer_tpu_torch.ops.cuda import lab
from skele_raytracer_tpu_torch.tools import kernel_lab
from tests.test_torch_lab_split import (ITEMS, _host_merge, _lab_case_arrays,
                                        host)  # noqa: F401 (a fixture)

# the JAX tools point JAX's compilation cache at ./.jax_cache and put their
# checkout first on sys.path when imported; the other tests keep both
_CACHE_DIR = jax.config.jax_compilation_cache_dir
_SYS_PATH = list(sys.path)
from tools import kernel_lab as j_kl  # noqa: E402
from tools import lab_probe as j_probe  # noqa: E402
from tools import lab_v5 as j_v5  # noqa: E402

sys.path[:] = _SYS_PATH
jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

T_REL = 1e-6

# (kernel, arguments, the JAX tool's launcher and its arguments): L1 with
# per_group, L2 without its split control path, where every tile settles,
# L6 (bf16x3 only) and L4's loop stage
CASES = [("lab_v6", dict(group_c=2, passes=6, per_group=True), j_v5.launch_v6,
          dict(group_c=2, passes=6, per_group=True)),
         ("lab_v5", dict(group_c=1, passes=6, split_path=False),
          j_v5.launch_v5, dict(group_c=1, passes=6, split_path=False)),
         ("lab_presplit", dict(group_c=2, passes=3), j_kl.launch_presplit,
          dict(group_c=2)),
         ("lab_probe", dict(group_c=2, passes=6, stage="loop"),
          j_probe.launch_probe, dict(group_c=2, passes=6, stage="loop"))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lab_case():
    (v0, v1, v2, m), (o, d), live = _lab_case_arrays()
    mesh = accel.build_clusters(*(torch.from_numpy(a) for a in
                                  (v0, v1, v2, m)), cluster_size=64)
    B = kernel_lab.batch_from_rays(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(live), mesh)
    Bj = {k: jnp.asarray(B[k]) for k in
          ("feats", "order", "counts", "ent", "lo", "hi", "kc", "aux")}
    Bj.update(cs=B["cs"], C=B["C"])
    return Bj, lab.lab_batch_from_numpy(B)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_merged_items_match_jax_tool(host, lab_case, case):
    kind, kw, launch, jkw = case
    Bj, b = lab_case
    with pltpu.force_tpu_interpret_mode():
        jt, jidx = launch(Bj, **jkw)()
    live = b.live.numpy() > 0
    jt, jidx = np.asarray(jt)[live], np.asarray(jidx)[live]
    n_groups = -(-int(b.counts.max()) // kw["group_c"])
    for L in ITEMS:
        parts = [lab.lab_nearest_torch(kind, b, groups=(p, p + L), **kw)
                 for p in range(0, n_groups, L)]
        t, idx = _host_merge(host, torch.stack([p[0] for p in parts]),
                             torch.stack([p[1] for p in parts]))
        t, idx = t.numpy()[live], idx.numpy()[live]
        hit = t < lab.BIG
        assert hit.sum() > 50  # the batch has hits to compare
        np.testing.assert_array_equal(hit, jt < lab.BIG)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(t[hit], jt[hit], rtol=T_REL, atol=0)
