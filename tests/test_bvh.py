"""BVH tests: build invariants + traversal parity vs the brute-force
closest-hit scan (the reference's only acceleration, src/hittable_list.h:25-39;
its bvh_node build was an empty stub, src/bvh.h:12-14)."""

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.bvh import (
    build_bvh,
    reorder_scene,
    bvh_closest_hit,
    sphere_bounds,
    SENTINEL,
)
from raytracingproject_tpu.ops.intersect import closest_hit
from raytracingproject_tpu.scene import Scene, make_cover_scene, make_three_sphere_scene


def random_scene(n, seed, moving=False):
    rng = np.random.default_rng(seed)
    c0 = rng.uniform(-5, 5, (n, 3))
    delta = rng.uniform(0, 0.5, (n, 3)) if moving else np.zeros((n, 3))
    return Scene(
        center0=jnp.asarray(c0, jnp.float32),
        center_delta=jnp.asarray(delta, jnp.float32),
        radius=jnp.asarray(rng.uniform(0.1, 0.8, n), jnp.float32),
        mat_type=jnp.zeros(n, jnp.int32),
        albedo=jnp.full((n, 3), 0.5, jnp.float32),
        fuzz=jnp.zeros(n, jnp.float32),
        ior=jnp.ones(n, jnp.float32),
    )


def random_rays(m, seed):
    rng = np.random.default_rng(seed)
    origin = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    direction = rng.normal(size=(m, 3)).astype(np.float32)
    time = rng.random(m).astype(np.float32)
    return jnp.asarray(origin), jnp.asarray(direction), jnp.asarray(time)


def assert_parity(scene, m_rays=256, seed=0):
    bvh = build_bvh(scene)
    sorted_scene = reorder_scene(scene, bvh)
    o, d, t = random_rays(m_rays, seed)

    ref = closest_hit(o, d, t, scene.center0, scene.center_delta, scene.radius)
    got = bvh_closest_hit(o, d, t, sorted_scene, bvh)

    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    t_ref = np.asarray(ref.t)[hit]
    t_got = np.asarray(got.t)[hit]
    # float32 cancellation on large spheres (r=1000 ground) gives ~1e-3
    # relative noise between two evaluation orders of the same quadratic
    np.testing.assert_allclose(t_got, t_ref, rtol=5e-3, atol=1e-3)
    # same sphere, except genuine near-ties where both ts agree to noise
    perm = np.asarray(bvh.prim_order)
    same = perm[np.asarray(got.idx)[hit]] == np.asarray(ref.idx)[hit]
    near_tie = np.abs(t_got - t_ref) <= 5e-3 * np.abs(t_ref) + 1e-3
    assert np.all(same | near_tie)
    nrm_ref = np.asarray(ref.normal)[hit][same]
    nrm_got = np.asarray(got.normal)[hit][same]
    np.testing.assert_allclose(nrm_got, nrm_ref, rtol=1e-3, atol=2e-3)


def test_build_invariants():
    scene = make_cover_scene(seed=0)
    bvh = build_bvh(scene)
    m = bvh.node_min.shape[0]
    n = scene.num_spheres

    # prim_order is a permutation
    assert sorted(np.asarray(bvh.prim_order).tolist()) == list(range(n))
    # leaves cover all primitives exactly once
    leaf = np.asarray(bvh.leaf_count) > 0
    total = int(np.asarray(bvh.leaf_count)[leaf].sum())
    assert total == n
    # miss links point forward (or sentinel)
    miss = np.asarray(bvh.miss_link)
    ids = np.arange(m)
    assert np.all((miss > ids) | (miss == SENTINEL))
    # child boxes inside parent box: every node box inside root box
    bmin = np.asarray(bvh.node_min)
    bmax = np.asarray(bvh.node_max)
    assert np.all(bmin >= bmin[0] - 1e-5) and np.all(bmax <= bmax[0] + 1e-5)
    # per-sphere bounds honour motion (src/sphere.h:19-28)
    sb_min, sb_max = sphere_bounds(scene)
    assert np.all(sb_min >= bmin[0] - 1e-4) and np.all(sb_max <= bmax[0] + 1e-4)


def test_parity_small_scene():
    assert_parity(make_three_sphere_scene(), seed=1)


def test_parity_random_static():
    assert_parity(random_scene(100, seed=2), seed=3)


def test_parity_random_moving():
    assert_parity(random_scene(64, seed=4, moving=True), seed=5)


def test_parity_cover_scene():
    assert_parity(make_cover_scene(seed=0), m_rays=512, seed=6)


def test_parity_single_sphere():
    assert_parity(random_scene(1, seed=7), seed=8)


def test_render_with_bvh_matches_brute_force():
    """Full render cover path: BVH and brute force must agree to float
    tolerance with identical keys (same RNG stream, same math)."""
    from raytracingproject_tpu.camera import Camera
    from raytracingproject_tpu.render import render
    from raytracingproject_tpu.config import RenderSettings

    scene = make_three_sphere_scene()
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=64,
        samples_per_pixel=8,
        max_depth=8,
        vfov=90.0,
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        defocus_angle=0.0,
        focus_dist=1.0,
    )
    key = jax.random.PRNGKey(9)
    brute = np.asarray(render(scene, cam, key, RenderSettings(use_bvh=False)))
    accel = np.asarray(render(scene, cam, key, RenderSettings(use_bvh=True)))
    # identical sampling decisions; tiny drift only where float argmin ties
    diff = np.abs(brute - accel)
    assert np.quantile(diff, 0.999) < 1e-4, np.quantile(diff, 0.999)
