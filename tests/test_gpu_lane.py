"""GPU-lane tests (RTP_BACKEND=gpu python -m pytest tests/ -m gpu), skipped
without a GPU. The kernels run compiled for the card, at the cover scene's
width, with the checks chip_smoke.py runs (raytracingproject_tpu.validation):

- statistical parity of the megakernel's full random bounce paths with the
  XLA renderer, per material region, and detection of an injected physics
  bug by the same statistic,
- miss recording (env-map support) as an exact refactor of the sky,
- the replay rebuilding the kernel's radiance, and replay gradients against
  reverse mode through the XLA renderer,
- golden-image comparisons with the reference tracer's render, when the
  path to its image.ppm is given in RTP_REFERENCE_IMAGE.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from raytracingproject_tpu.camera import Camera, generate_rays
from raytracingproject_tpu.render import ray_color
from raytracingproject_tpu.scene import make_cover_scene
from raytracingproject_tpu.validation import (
    GRAD_RTOL, REPLAY_RTOL, Z_MAX, assert_statistically_equal,
    material_labels, region_z_scores, replay_grad_errors, replay_rebuild_error,
)

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_device")]

W, H, SPP, DEPTH = 400, 225, 8, 50
COVER_CAM = dict(
    aspect_ratio=16 / 9, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
    lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
)


def _frame_rays(width, height, spp, key, **cam_kw):
    cam = Camera(image_width=width, samples_per_pixel=spp, max_depth=DEPTH,
                 **cam_kw).derive()
    jj, ii = jnp.meshgrid(jnp.arange(height, dtype=jnp.int32),
                          jnp.arange(width, dtype=jnp.int32), indexing="ij")
    i = jnp.tile(ii.reshape(-1), spp)
    j = jnp.tile(jj.reshape(-1), spp)
    return generate_rays(cam, i, j, key)


@pytest.fixture(scope="module")
def scene():
    return make_cover_scene(seed=0)


@pytest.fixture(scope="module")
def cover_rays():
    return _frame_rays(W, H, SPP, jax.random.PRNGKey(0), **COVER_CAM)


@pytest.mark.parametrize("inject_bug", [None, "schlick3"])
def test_compiled_megakernel_region_statistics(scene, cover_rays, inject_bug):
    """Per-sample radiance of 720k cover-scene rays at depth 50: every
    material region within Z_MAX standard errors of the XLA renderer, and
    the dielectric region far outside them with a wrong Schlick exponent."""
    from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_paths

    o, d, t = cover_rays
    labels = material_labels(scene, o, d, t)
    pk = pallas_trace_paths(o, d, t, scene, jnp.int32(11), DEPTH,
                            inject_bug=inject_bug)
    xla = jax.jit(lambda o, d, t: ray_color(
        scene, o, d, t, jax.random.PRNGKey(5), DEPTH, early_exit=True))
    chunk = 1 << 18  # bounds the XLA path's [rays, spheres] arrays
    xk = jnp.concatenate([xla(o[s:s + chunk], d[s:s + chunk], t[s:s + chunk])
                          for s in range(0, o.shape[0], chunk)])
    assert np.isfinite(np.asarray(pk)).all()
    if inject_bug is None:
        assert_statistically_equal(pk, xk, labels)
    else:
        z = region_z_scores(pk, xk, labels)
        assert z["dielectric"] > Z_MAX, z


def test_compiled_record_miss_identity(scene, cover_rays):
    """radiance + miss_thr * sky(miss_dir) of the miss-recording kernel
    equals the plain kernel's radiance with the same seed."""
    from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_paths
    from raytracingproject_tpu.render import sky_color

    o, d, t = cover_rays
    plain = np.asarray(pallas_trace_paths(o, d, t, scene, jnp.int32(7), DEPTH))
    rad, mdir, mthr = pallas_trace_paths(o, d, t, scene, jnp.int32(7), DEPTH,
                                         record_miss=True)
    total = np.asarray(rad + mthr * sky_color(mdir))
    np.testing.assert_allclose(total, plain, atol=5e-5)


@pytest.mark.parametrize("depth", [8, 50])
def test_compiled_replay_rebuilds_kernel_radiance(scene, depth):
    o, d, t = _frame_rays(W, H, 1, jax.random.PRNGKey(5), **COVER_CAM)
    assert replay_rebuild_error(scene, o, d, t, 6, depth) < REPLAY_RTOL


@pytest.mark.parametrize("depth", [8, 50])
def test_compiled_replay_gradients_match_reverse_mode(scene, depth):
    o, d, t = _frame_rays(W, H, 1, jax.random.PRNGKey(5), **COVER_CAM)
    sub = slice(0, None, 22)
    errs = replay_grad_errors(scene, o[sub], d[sub], t[sub],
                              jax.random.PRNGKey(7), depth)
    assert max(errs.values()) < GRAD_RTOL, errs


def _reference_image():
    path = os.environ.get("RTP_REFERENCE_IMAGE")
    if not path or not Path(path).exists():
        pytest.skip("set RTP_REFERENCE_IMAGE to the reference tracer's image.ppm")
    from raytracingproject_tpu.utils.ppm import read_ppm

    return read_ppm(path).astype(np.float64) / 255.0


def test_full_resolution_golden_image():
    """The 400x225 cover render through the megakernel against the reference
    tracer's committed render: global, sky-band and row-profile means."""
    from raytracingproject_tpu.color import to_u8
    from raytracingproject_tpu.config import RenderSettings
    from raytracingproject_tpu.render import render

    ref = _reference_image()
    cam = Camera(image_width=400, samples_per_pixel=8, max_depth=50, **COVER_CAM)
    img = render(make_cover_scene(seed=0), cam, jax.random.PRNGKey(0),
                 RenderSettings(use_megakernel=True))
    img = np.asarray(to_u8(img)).astype(np.float64) / 255.0
    assert img.shape == ref.shape
    np.testing.assert_allclose(img.mean(axis=(0, 1)), ref.mean(axis=(0, 1)), atol=0.035)
    np.testing.assert_allclose(
        img[:30].mean(axis=(0, 1)), ref[:30].mean(axis=(0, 1)), atol=0.02
    )
    assert np.abs(img.mean(axis=(1, 2)) - ref.mean(axis=(1, 2))).mean() < 0.04


# Evaluation order of the reference's RNG-consuming constructor arguments,
# determined empirically against the committed golden image (see
# scene.make_cover_scene_reference): right-to-left, MSVC's order.
REF_ARG_ORDER = "rl"


def test_per_pixel_golden_matched_spp():
    """The reference's exact scene (bit-exact mt19937 replay of
    src/main.cpp:17-43) at its own 400x225, 30 spp, depth 50, per pixel
    against the committed golden image. The per-pixel noise sigma is
    estimated from a second independent render, smoothed 5x5; >= 99% of
    channels must lie within 4 sigma + the quantization floor, and the mean
    absolute error under 0.03."""
    from raytracingproject_tpu.color import to_u8
    from raytracingproject_tpu.config import RenderSettings
    from raytracingproject_tpu.render import render
    from raytracingproject_tpu.scene import make_cover_scene_reference

    ref = _reference_image()
    scene = make_cover_scene_reference(arg_order=REF_ARG_ORDER)
    cam = Camera(image_width=400, samples_per_pixel=30, max_depth=50, **COVER_CAM)
    st = RenderSettings(use_megakernel=True)

    def go(key):
        return np.asarray(to_u8(render(scene, cam, key, st))).astype(np.float64) / 255.0

    img_a = go(jax.random.PRNGKey(11))
    img_b = go(jax.random.PRNGKey(22))
    assert img_a.shape == ref.shape
    var = ((img_a - img_b) ** 2) / 2.0
    k = 5
    pad = np.pad(var, ((k // 2, k // 2), (k // 2, k // 2), (0, 0)), mode="edge")
    sm = np.zeros_like(var)
    for dy in range(k):
        for dx in range(k):
            sm += pad[dy: dy + var.shape[0], dx: dx + var.shape[1]]
    sigma = np.sqrt(sm / (k * k))
    d = np.abs(img_a - ref)
    frac_ok = float((d <= 4.0 * sigma + 3.0 / 255.0).mean())
    assert frac_ok >= 0.99, f"only {frac_ok:.2%} of channels within tolerance"
    assert float(d.mean()) < 0.03, f"mean |delta| = {float(d.mean()):.4f}"
