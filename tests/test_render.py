"""End-to-end renderer tests: JAX megakernel vs the float64 numpy oracle,
golden-value regressions, and the reference's golden-pixel test recast
statistically (tests/tests.cpp:35-45).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.camera import Camera, generate_rays
from raytracingproject_tpu.render import render, ray_color, sky_color
from raytracingproject_tpu.scene import (
    make_minimal_scene,
    make_three_sphere_scene,
    make_ground_scene,
)

from oracle import render_np, trace_np, scene_to_numpy


def small_camera(**overrides):
    kw = dict(
        aspect_ratio=16.0 / 9.0,
        image_width=64,
        samples_per_pixel=32,
        max_depth=8,
        vfov=90.0,
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        defocus_angle=0.0,
        focus_dist=1.0,
    )
    kw.update(overrides)
    return Camera(**kw)


def test_sky_only():
    """Rays that miss everything return the sky gradient exactly
    (src/camera_cpu.h:23-25) — deterministic, no MC noise."""
    scene = make_minimal_scene()
    # straight up: unit_dir.y=1 -> a=1 -> (0.5,0.7,1.0)
    up = jnp.asarray([[0.0, 1.0, 0.0]])
    rad = ray_color(
        scene,
        jnp.asarray([[0.0, 5.0, 0.0]]),
        up,
        jnp.zeros((1,)),
        jax.random.PRNGKey(0),
        max_depth=4,
    )
    np.testing.assert_allclose(np.asarray(rad[0]), [0.5, 0.7, 1.0], atol=1e-6)
    # horizontal: a=0.5 -> (0.75, 0.85, 1.0)
    rad = ray_color(
        scene,
        jnp.asarray([[0.0, 5.0, 0.0]]),
        jnp.asarray([[1.0, 0.0, 0.0]]),
        jnp.zeros((1,)),
        jax.random.PRNGKey(0),
        max_depth=4,
    )
    np.testing.assert_allclose(np.asarray(rad[0]), [0.75, 0.85, 1.0], atol=1e-6)


def test_depth_zero_semantics():
    """depth exhausted -> black (src/camera_cpu.h:11-13): a ray bouncing
    between surfaces with max_depth=1 that hits returns only what one
    bounce can give; with max_depth large, lambertian-only scene converges
    under albedo product."""
    scene = make_minimal_scene()
    origin = jnp.asarray([[0.0, 0.0, 0.0]])
    direction = jnp.asarray([[0.0, 0.0, -1.0]])  # hits the 0.5-radius sphere
    time = jnp.zeros((1,))
    # With depth=1 the ray hits and scatters but never evaluates sky -> black.
    rad = ray_color(scene, origin, direction, time, jax.random.PRNGKey(0), max_depth=1)
    np.testing.assert_allclose(np.asarray(rad[0]), [0.0, 0.0, 0.0], atol=1e-7)


def test_minimal_scene_matches_oracle():
    """Benchmark config 1: one Lambertian sphere + ground, vs float64 oracle.
    MC-noise-aware: compare per-pixel means at matched spp with tolerance
    a few sigma of the pixel-mean estimator."""
    scene = make_minimal_scene()
    cam = small_camera(samples_per_pixel=64)
    img = np.asarray(render(scene, cam, jax.random.PRNGKey(7)))
    ref = render_np(scene, cam, spp=64)

    diff = np.abs(img - ref)
    assert diff.mean() < 0.015, diff.mean()
    assert np.quantile(diff, 0.99) < 0.12, np.quantile(diff, 0.99)


def test_three_sphere_scene_matches_oracle():
    """Benchmark config 2 scene (lambertian+metal+dielectric)."""
    scene = make_three_sphere_scene()
    cam = small_camera(samples_per_pixel=96, max_depth=16)
    img = np.asarray(render(scene, cam, jax.random.PRNGKey(3)))
    ref = render_np(scene, cam, spp=96)

    diff = np.abs(img - ref)
    assert diff.mean() < 0.02, diff.mean()
    assert np.quantile(diff, 0.99) < 0.15, np.quantile(diff, 0.99)


def test_golden_pixel_ground_scene():
    """The reference golden-pixel test (tests/tests.cpp:35-45): center-pixel
    ray of the ground-sphere world with the cover camera = (0.253, 0.3518,
    0.5) +- 1e-3 for its mt19937 stream. Our RNG differs, so we assert the
    *expectation* over many samples matches the float64 oracle expectation,
    and pin a fixed-key golden for regression."""
    scene = make_ground_scene()
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=400,
        samples_per_pixel=30,
        max_depth=50,
        vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6,
        focus_dist=10.0,
    )
    d = cam.derive()
    n = 4096
    i = jnp.full((n,), 200, jnp.int32)
    j = jnp.full((n,), 112, jnp.int32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    origin, direction, time = generate_rays(d, i, j, k1)
    rad = np.asarray(ray_color(scene, origin, direction, time, k2, max_depth=50))
    mean = rad.mean(axis=0)

    # float64 oracle expectation at the same pixel
    sc = scene_to_numpy(scene)
    rng = np.random.default_rng(99)
    o64 = np.asarray(origin, np.float64)
    d64 = np.asarray(direction, np.float64)
    t64 = np.asarray(time, np.float64)
    ref = trace_np(sc, o64, d64, t64, rng, 50).mean(axis=0)

    np.testing.assert_allclose(mean, ref, atol=0.02)
    # sanity: in the reference's ballpark (its single-sample golden was
    # (0.253, 0.3518, 0.5); the expectation sits near it)
    assert np.all(np.abs(mean - np.array([0.253, 0.3518, 0.5])) < 0.12), mean


def test_render_deterministic_given_key():
    scene = make_minimal_scene()
    cam = small_camera(image_width=32, samples_per_pixel=4)
    a = np.asarray(render(scene, cam, jax.random.PRNGKey(5)))
    b = np.asarray(render(scene, cam, jax.random.PRNGKey(5)))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(render(scene, cam, jax.random.PRNGKey(6)))
    assert np.abs(a - c).max() > 0


def test_block_order_roundtrip():
    """_block_order invariants (the megakernel ray-feed permutation):
    every pixel gets exactly spp ray slots, padding repeats pixel 0, and
    the [spp, H*W] gather plus blocks_to_image's once-per-frame variant
    reconstruct exactly the per-pixel sample sums."""
    import numpy as np

    from raytracingproject_tpu.render import _block_order

    for (w, h, spp) in [(40, 23, 4), (64, 36, 1), (33, 17, 3)]:
        slot_pix, gather = _block_order(w, h, spp, tile=128)
        n = w * h
        assert slot_pix.size % 128 == 0
        counts = np.bincount(slot_pix[: spp * n], minlength=n)
        assert (counts == spp).all()          # each pixel sampled spp times
        assert (slot_pix[spp * n:] == 0).all()  # padding renders pixel 0
        assert gather.shape == (spp, n)
        assert np.array_equal(slot_pix[gather[2 % spp]], np.arange(n))
        # emulate raw-slot accumulation: rad[slot] = pix * 10 + sample index
        rad = np.zeros(slot_pix.size)
        seen = {}
        for slot, pix in enumerate(slot_pix[: spp * n]):
            s = seen.get(pix, 0)
            seen[pix] = s + 1
            rad[slot] = pix * 10 + s
        img = rad[gather].sum(axis=0)  # blocks_to_image without the reshape
        expect = np.arange(n) * 10 * spp + spp * (spp - 1) / 2
        np.testing.assert_array_equal(img, expect)


def test_megakernel_with_bvh_raises():
    """No GPU kernel traverses a BVH: asking for both raises instead of
    quietly using brute force."""
    import pytest

    from raytracingproject_tpu.config import RenderSettings

    scene = make_minimal_scene()
    cam = small_camera(image_width=8, samples_per_pixel=1)
    with pytest.raises(ValueError, match="no GPU kernel traverses a BVH"):
        render(scene, cam, jax.random.PRNGKey(0),
               RenderSettings(use_megakernel=True, use_bvh=True))


def test_render_pass_megakernel_slots_and_env_map():
    """render_pass's megakernel plumbing, interpreted: raw slot-space output
    through blocks_to_image equals the row-major image, and a sky texture
    rides the miss planes."""
    from raytracingproject_tpu.render import blocks_to_image, render_pass

    scene = make_minimal_scene()
    cam = small_camera(image_width=8, samples_per_pixel=1)  # 64 rays
    w, h = cam.image_size()
    kw = dict(width=w, height=h, max_depth=3, spp_chunk=2,
              use_megakernel=True, interpret=True)
    key = jax.random.PRNGKey(4)
    img = np.asarray(render_pass(scene, cam.derive(), key, **kw))
    slots = render_pass(scene, cam.derive(), key, raw_slots=True, **kw)
    np.testing.assert_allclose(
        np.asarray(blocks_to_image(slots, w, h, 2)), img, atol=1e-6)
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    tex = jnp.full((4, 8, 3), 0.25, jnp.float32)
    far = scene._replace(center0=scene.center0 + 1e7)  # every ray misses
    sky = np.asarray(render_pass(far, cam.derive(), key, sky_tex=tex, **kw))
    np.testing.assert_allclose(sky, 2 * 0.25, atol=1e-5)
