"""The 3-step fit through the fused route (kernel K7's plain version) on
lit dragon, against the same fit through the JAX package's jnp path, on
the CPU: chip_smoke.py's fused fit (clean, gillum 4, depth 2, shadows,
every triangle leaf trainable, v0 moved by 0.01, the target rendered at
another seed) cut to 24x18.

The JAX package's jnp path intersects the triangles themselves; the port's
mesh kernels read a Morton-clustered copy, which a scene edited with
`dataclasses.replace` still holds for the old vertices. `train.fit` used
to render its first step from that stale copy (first loss 0.023807 here
against JAX's 0.037129) and rebuild it only after the step, so the loss
jumped at step 1; it now rebuilds the copy before the first step. Losses
within 1e-5 relative of JAX's (the same float32 math, summed in another
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import TARGET_SEED
from skele_raytracer_tpu.config import CLEAN as J_CLEAN
from skele_raytracer_tpu.config import RenderConfig as JConfig
from skele_raytracer_tpu.models import train as j_train
from skele_raytracer_tpu.scene.parser import parse_scene as j_parse
from skele_raytracer_tpu_torch.config import CLEAN, RenderConfig
from skele_raytracer_tpu_torch.models import train
from skele_raytracer_tpu_torch.models.renderer import render_radiance
from skele_raytracer_tpu_torch.scene.convert import (
    scene_from_numpy,
    scene_to_numpy,
)

REPO = __file__.rsplit("/", 2)[0]
FRAME = dict(width=24, height=18, use_shadows=True, max_depth=2,
             monte_carlo=True, num_paths=4)


def _replace(x, **kw):
    return x._replace(**kw) if hasattr(x, "_replace") else dataclasses.replace(
        x, **kw)


@pytest.fixture(scope="module")
def lit_dragon_fit():
    """(JAX scene, port scene, target [H, W, 3]): dragon.scn, clean, its
    directional light flipped to shine from above (chip_smoke.py
    `lit_dragon`), and the target rendered through the fused route."""
    jscene = j_parse(f"{REPO}/scenes/dragon.scn").to_scene(J_CLEAN)
    dl = jscene.directional_lights
    jscene = _replace(jscene, directional_lights=_replace(
        dl, direction=-dl.direction))
    scene = scene_from_numpy(*scene_to_numpy(jscene))
    cfg = RenderConfig(quirks=CLEAN, backend="torch", fused_megakernel=True,
                       **FRAME)
    with torch.no_grad():
        target = render_radiance(scene, cfg, TARGET_SEED)
    return jscene, scene, target


@pytest.mark.parametrize("lr", [1e-3, 3e-5])
def test_fused_fit_matches_jax_jnp_fit(lit_dragon_fit, lr):
    jscene, scene, target = lit_dragon_fit
    tr, jtr = scene.triangles, jscene.triangles
    start = dataclasses.replace(scene, triangles=dataclasses.replace(
        tr, v0=tr.v0 + 0.01))
    jstart = _replace(jscene, triangles=_replace(jtr, v0=jtr.v0 + 0.01))
    cfg = RenderConfig(quirks=CLEAN, backend="torch", fused_megakernel=True,
                       **FRAME)
    _, losses = train.fit(start, cfg, target, steps=3, learning_rate=lr,
                          log_every=0, trainable_paths=("triangles",))
    _, want = j_train.fit(jstart, JConfig(quirks=J_CLEAN, backend="jnp",
                                          **FRAME),
                          jnp.asarray(target.numpy()), steps=3,
                          learning_rate=lr, log_every=0,
                          trainable_paths=("triangles",))
    np.testing.assert_allclose(losses, want, rtol=1e-5)
