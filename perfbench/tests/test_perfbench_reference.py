"""The plain reference against the program's plain path (backend "torch")
at tiny sizes, and the frozen work counts against the program's
utils/roofline.py at the cells' shapes. The card test holds the
reference against the program's kernels."""

from __future__ import annotations

import pytest
import torch

from perfbench import work
from perfbench.reference import render as rr
from perfbench.reference import scene as rs
from perfbench.reference import train as rt
from perfbench.tests.tiny import REPO, cut_mesh

torch.set_num_threads(2)
SPHERES2 = (REPO / "perfbench" / "scenes" / "spheres2.scn").read_text()
DRAGON = (REPO / "perfbench" / "scenes" / "dragon.scn").read_text()


def port_scene(text, parity, device="cpu"):
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY
    from skele_raytracer_tpu_torch.scene.parser import parse_scene_text

    return parse_scene_text(text).to_scene(PARITY if parity else CLEAN,
                                           device=device)


def port_cfg(c: rr.Config, backend="torch", **kw):
    from skele_raytracer_tpu_torch.config import CLEAN, PARITY, RenderConfig

    return RenderConfig(width=c.width, height=c.height,
                        monte_carlo=c.gillum > 0, num_paths=c.paths,
                        max_depth=c.depth, use_shadows=c.shadows,
                        grid_size=c.jsample,
                        quirks=PARITY if c.parity else CLEAN,
                        backend=backend, **kw)


def port_radiance(text, c, seed, ids, backend="torch", device="cpu", **kw):
    from skele_raytracer_tpu_torch.models.renderer import render_ids_chunked

    with torch.no_grad():
        return render_ids_chunked(port_scene(text, c.parity, device),
                                  port_cfg(c, backend, **kw), seed,
                                  ids.to(device)).cpu()


CASES = {
    "spheres2-parity": (SPHERES2, rr.Config(32, 24, True, 16, 2, True)),
    "spheres2-clean-fog": (SPHERES2, rr.Config(32, 24, False, 4, 2, True)),
    "spheres2-parity-jsample2": (SPHERES2, rr.Config(16, 12, True, 4, 3,
                                                     True, 2)),
    "spheres2-clean-jsample2": (SPHERES2, rr.Config(16, 12, False, 0, 1,
                                                    True, 2)),
    "dragon64-clean": (cut_mesh(DRAGON, 64), rr.Config(32, 24, False, 4, 2,
                                                       True)),
    "dragon64-parity": (cut_mesh(DRAGON, 64), rr.Config(32, 24, True, 4, 2,
                                                        True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_plain_path(case):
    text, c = CASES[case]
    ids = torch.arange(c.width * c.height * c.spp)
    seed = 3_000_000_019
    ref = rr.render_ids(rs.build(rs.parse(text), c.parity), c, seed, ids)
    prog = port_radiance(text, c, seed & 0xFFFFFFFF, ids)
    assert torch.isfinite(ref).all()
    assert (ref - prog).abs().max().item() <= 2e-6


def test_reference_matches_the_plain_path_on_the_whole_dragon():
    """640x480 dragon, 48 pixels near its middle: the culled kernels'
    plain versions against brute force over all 10,002 triangles."""
    c = rr.Config(640, 480, False, 4, 2, True)
    g = torch.Generator().manual_seed(5)
    px = ((160 + torch.randint(0, 160, (48,), generator=g)) * 640
          + 240 + torch.randint(0, 160, (48,), generator=g))
    ref = rr.render_ids(rs.build(rs.parse(DRAGON), False), c, 99, px)
    prog = port_radiance(DRAGON, c, 99, px)
    assert (ref - torch.tensor([0.125, 0.5, 1.0])).abs().sum(1).gt(1e-3).any()
    assert (ref - prog).abs().max().item() <= 2e-6


def test_reference_parse_reads_what_the_program_reads():
    from skele_raytracer_tpu_torch.scene.types import leaf_items

    for parity in (True, False):
        ref = dict(rs.build(rs.parse(SPHERES2), parity).leaves())
        for name, v in leaf_items(port_scene(SPHERES2, parity)):
            if name in ref:
                n = ref[name].shape[0] if ref[name].dim() else None
                got = v[:n] if n is not None else v
                assert torch.equal(got, ref[name]), name


def test_reference_training_step_matches_the_program():
    """Two steps of the program's train_step (plain path) and of the
    reference's from the same start and target: losses, first gradients
    and leaves agree to float32 rounding."""
    from perfbench.modes.train_step import start_values
    from skele_raytracer_tpu_torch.models import train
    from skele_raytracer_tpu_torch.scene.types import (
        leaf_items,
        replace_leaves,
    )

    c = rr.Config(24, 16, True, 4, 2, True)
    names = ["spheres.diffuse", "point_lights.colour"]
    start = {"spheres.diffuse": {"set": 0.5},
             "point_lights.colour": {"scale": 0.3}}
    sc = rs.build(rs.parse(SPHERES2), True)
    target = rt.target_frame(sc, c, 1000003)
    sc = sc.with_leaves(start_values(dict(sc.leaves()), start))
    losses, first, after = rt.follow(sc, c, 41, target, names, 5e-3, 2,
                                     torch.float32)

    ps = port_scene(SPHERES2, True)
    vals = start_values(dict(leaf_items(ps)), start)
    ps = replace_leaves(ps, [vals[n] for n, _ in leaf_items(ps)])
    mask = train.make_trainable_mask(ps, tuple(names))
    state = train.init_state(ps, 5e-3, mask)
    got = []
    for _ in range(2):
        state, loss = train.train_step(state, port_cfg(c), 41, target,
                                       trainable=mask)
        got.append(float(loss))
    leaves = dict(leaf_items(state.scene))
    for a, b in zip(got, losses):
        assert abs(a - b) <= 1e-6 * abs(b)
    d = "spheres.diffuse"
    assert torch.allclose(leaves[d].detach()[:after[d].shape[0]], after[d],
                          rtol=0, atol=1e-6)
    assert first[d].abs().max() > 0


@pytest.mark.parametrize("parity", [True, False])
def test_frozen_counts_equal_the_programs(parity):
    from skele_raytracer_tpu_torch.ops.cuda import pathtrace
    from skele_raytracer_tpu_torch.utils import roofline

    c = rr.Config(1920, 1080, parity, 16, 2, True)
    st = work.static_args(rs.build(rs.parse(SPHERES2), parity), c)
    pst = pathtrace._static_kernel_args(port_scene(SPHERES2, parity),
                                        port_cfg(c))
    n = 1920 * 1080
    assert work.k1_work(st, n) == roofline.k1_work(pst, n)
    assert work.k1_work(st, n, records=True) == roofline.k1_work(
        pst, n, records=True)
    assert work.k2_work(st, n) == roofline.k2_work(pst, n)
    assert work.roofline(1e9, 1e6, 1e6, 1e9) == roofline.roofline(
        1e9, 1e6, 1e6, 1e9)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spheres2-parity", "dragon-clean",
                                  "dragon-clean-fused"])
def test_reference_matches_the_kernels_on_the_card(case):
    """The program's kernels (K1; K3 and K4; K7) against the reference on
    the card, at the cells' frames, on sampled pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    text, c = ((SPHERES2, rr.Config(1920, 1080, True, 16, 2, True))
               if case.startswith("spheres2")
               else (DRAGON, rr.Config(640, 480, False, 16, 2, True)))
    g = torch.Generator().manual_seed(11)
    px = torch.randperm(c.width * c.height, generator=g)[:2048]
    kw = {"fused_megakernel": True} if case.endswith("fused") else {}
    ref = rr.render_ids(rs.build(rs.parse(text), c.parity, device="cuda"), c,
                        7, px.cuda()).cpu()
    prog = port_radiance(text, c, 7, px, "cuda", "cuda", **kw)
    assert ((ref - prog).abs() > 1e-4).float().mean() <= 0.01
