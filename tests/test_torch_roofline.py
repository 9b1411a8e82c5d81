"""utils/roofline.py on the CPU: tests/test_roofline.py's cases of the
frame model and the bound's flip on the port, and the kernels' bounds
pinned to the values chip_smoke.py computed with its own copy of these
functions before they moved here (tolerance 5e-7 ms: the six printed
digits)."""

import pytest

import chip_smoke
from skele_raytracer_tpu_torch.config import CLEAN, PARITY
from skele_raytracer_tpu_torch.ops.cuda import pathtrace as pt
from skele_raytracer_tpu_torch.utils import roofline


def test_frame_model_headline_magnitudes():
    m = roofline.frame_model(width=1920, height=1080, paths=16, depth=2,
                             s_pad=16)
    assert m["segments"] == 1920 * 1080 * 17
    # ~1 kFLOP/segment and ~100 B/segment floors
    assert 20e9 < m["flops"] < 60e9
    assert m["hbm_bytes_min"] > m["segments"] * 96

    s = roofline.sol_summary(m, 0.094)
    assert s["bound"] in ("fp32", "hbm")
    assert 0 < s["fp32_pct"] < 100 and 0 < s["hbm_pct"] < 100
    assert s["achieved_tflops"] > 0
    assert "device" not in s
    d = roofline.sol_summary(m, 0.094, device_seconds=0.047)
    assert d["device_busy_pct"] == pytest.approx(50.0)
    assert d["device"]["fp32_pct"] == pytest.approx(2 * s["fp32_pct"],
                                                    rel=1e-9)


def test_sol_summary_bound_flips():
    # huge flops, tiny bytes -> fp32-bound; reverse -> hbm-bound
    fp32 = roofline.sol_summary({"flops": 1e15, "hbm_bytes_min": 1}, 1.0)
    hbm = roofline.sol_summary({"flops": 1.0, "hbm_bytes_min": 1e12}, 1.0)
    assert fp32["bound"] == "fp32" and hbm["bound"] == "hbm"
    # the SFU and INT32 ceilings count where the model holds them
    sfu = roofline.sol_summary({"flops": 1.0, "hbm_bytes_min": 1.0,
                                "sfu": 1e12, "int32": 1.0}, 1.0)
    assert sfu["bound"] == "sfu" and "int32_pct" in sfu


def _headline_static(quirks):
    scene, cfg = chip_smoke.headline(quirks, device="cpu")
    return (pt._static_kernel_args(chip_smoke.perturbed(scene), cfg),
            cfg.width * cfg.height * cfg.samples_per_pixel)


def test_bounds_pinned_to_chip_smoke_values():
    st, n = _headline_static(PARITY)
    for got, want, by in (
            (roofline.k1_work(st, n), 0.187460, "operations"),
            (roofline.k1_work(st, n, records=True), 0.187460, "operations"),
            (roofline.k2_work(st, n), 0.416529, "operations"),
            (roofline.k5_work(65536, 700), 0.027388, "operations"),
            (roofline.k6_work(65536, 16), 0.000724, "bytes")):
        assert got[0] == pytest.approx(want, abs=5e-7) and got[1] == by
    st, n = _headline_static(CLEAN)
    assert roofline.k1_work(st, n)[0] == pytest.approx(1.319008, abs=5e-7)
    assert roofline.k2_work(st, n)[0] == pytest.approx(3.957025, abs=5e-7)
    # chip_smoke.py keeps no copy: its bounds are these functions
    for name in ("k1_work", "k2_work", "k5_work", "k6_work", "mesh_work",
                 "occluded_work", "fused_work", "k1_model"):
        assert getattr(chip_smoke, name) is getattr(roofline, name), name
    assert not hasattr(chip_smoke, "FP32_PEAK")
    m = roofline.k1_model(*_headline_static(PARITY))
    assert set(m) == {"flops", "sfu", "int32", "hbm_bytes_min"}
