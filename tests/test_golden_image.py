"""Golden-image comparison against the reference's committed render.

/root/reference/image.ppm is the CPU tracer's output of the cover scene at
400x225, 30 spp, depth 50 (src/main.cpp:55-68). Our cover scene uses a
different RNG stream for BOTH scene generation (sphere placement) and path
sampling, so pixel-exact comparison is impossible; what must match is the
global image statistics (the deterministic big spheres + ground + sky
dominate) within Monte-Carlo + scene-layout tolerance.

Full per-pixel parity is validated elsewhere against our own float64 oracle
(test_render.py) where scenes are identical.

The default test renders at reduced resolution/spp so the CPU-mesh test
suite stays fast; global means and the vertical brightness profile are
resolution-independent statistics. Set RTP_FULL_GOLDEN=1 to render the
full 400x225 @ 8 spp comparison (minutes on the CPU).
"""

import os
from pathlib import Path

import numpy as np
import jax
import pytest

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.color import to_u8
from raytracingproject_tpu.config import RenderSettings
from raytracingproject_tpu.render import render
from raytracingproject_tpu.scene import make_cover_scene
from raytracingproject_tpu.utils.ppm import read_ppm

REF = Path("/root/reference/image.ppm")


def _cover_camera(width: int, spp: int) -> Camera:
    # src/main.cpp:55-68 camera, at the given resolution/spp
    return Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=width,
        samples_per_pixel=spp,
        max_depth=50,
        vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6,
        focus_dist=10.0,
    )


def _render_cover(width: int, spp: int) -> np.ndarray:
    scene = make_cover_scene(seed=0)
    cam = _cover_camera(width, spp)
    img = render(scene, cam, jax.random.PRNGKey(0), RenderSettings(use_bvh=True))
    return np.asarray(to_u8(img)).astype(np.float64) / 255.0


def _row_profile(img: np.ndarray, rows: int) -> np.ndarray:
    """Mean brightness per row, resampled to `rows` points."""
    prof = img.mean(axis=(1, 2))
    x = np.linspace(0.0, 1.0, prof.shape[0])
    return np.interp(np.linspace(0.0, 1.0, rows), x, prof)


def test_cover_scene_statistics_match_reference():
    if not REF.exists():
        pytest.skip("reference image not mounted")
    ref = read_ppm(REF).astype(np.float64) / 255.0

    img = _render_cover(width=100, spp=4)
    assert img.shape == (56, 100, 3)

    # global statistics: mean brightness per channel within a few percent
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), atol=0.04)
    # sky region (top ~13% of rows) is deterministic: tight match
    np.testing.assert_allclose(
        img[:7].mean(axis=(0, 1)), ref[:30].mean(axis=(0, 1)), atol=0.025
    )
    # ground/sphere region: same overall structure (vertical brightness profile)
    assert np.abs(_row_profile(img, 56) - _row_profile(ref, 56)).mean() < 0.045


@pytest.mark.skipif(
    not os.environ.get("RTP_FULL_GOLDEN"),
    reason="full-resolution golden render; set RTP_FULL_GOLDEN=1",
)
def test_cover_scene_full_resolution_match():
    if not REF.exists():
        pytest.skip("reference image not mounted")
    ref = read_ppm(REF).astype(np.float64) / 255.0

    img = _render_cover(width=400, spp=8)
    assert img.shape == ref.shape
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), atol=0.035)
    np.testing.assert_allclose(
        img[:30].mean(axis=(0, 1)), ref[:30].mean(axis=(0, 1)), atol=0.02
    )
    row_img = img.mean(axis=(1, 2))
    row_ref = ref.mean(axis=(1, 2))
    assert np.abs(row_img - row_ref).mean() < 0.04
