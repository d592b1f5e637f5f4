"""Sharding tests on the virtual 8-device CPU mesh (SURVEY.md §4's fake
backend): sharded render parity, sharded training step, mesh factorization."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.parallel import make_mesh, render_sharded, make_sharded_train_step
from raytracingproject_tpu.render import render
from raytracingproject_tpu.scene import make_three_sphere_scene, make_minimal_scene
from raytracingproject_tpu.grad.inverse import extract_params


def small_camera(**overrides):
    kw = dict(
        aspect_ratio=16.0 / 9.0,
        image_width=64,
        samples_per_pixel=16,
        max_depth=6,
        vfov=90.0,
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        defocus_angle=0.0,
        focus_dist=1.0,
    )
    kw.update(overrides)
    return Camera(**kw)


def test_requires_8_devices():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"


@pytest.mark.parametrize("samples_axis", [1, 2, 8])
def test_mesh_factorization(samples_axis):
    mesh = make_mesh(samples_axis_size=samples_axis)
    assert mesh.shape["samples"] == samples_axis
    assert mesh.shape["rays"] == 8 // samples_axis


def test_mesh_bad_factor_raises():
    with pytest.raises(ValueError):
        make_mesh(samples_axis_size=3)


@pytest.mark.parametrize("samples_axis", [1, 2, 4])
def test_render_sharded_matches_statistics(samples_axis):
    """Sharded and unsharded renders use different key derivations, so
    compare statistically: same scene/camera, matched spp, MC tolerance."""
    scene = make_three_sphere_scene()
    cam = small_camera(samples_per_pixel=32)
    mesh = make_mesh(samples_axis_size=samples_axis)
    img_sharded = np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(0), mesh))
    img_ref = np.asarray(render(scene, cam, jax.random.PRNGKey(1)))
    diff = np.abs(img_sharded - img_ref)
    assert diff.mean() < 0.025, diff.mean()
    assert np.quantile(diff, 0.99) < 0.2


def test_render_sharded_deterministic():
    scene = make_minimal_scene()
    cam = small_camera(image_width=32, samples_per_pixel=8)
    mesh = make_mesh(samples_axis_size=2)
    a = np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(3), mesh))
    b = np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(3), mesh))
    np.testing.assert_array_equal(a, b)


def test_sharded_train_step_runs_and_descends():
    scene = make_minimal_scene()
    cam = small_camera(image_width=32, samples_per_pixel=8, max_depth=4)
    mesh = make_mesh(samples_axis_size=2)

    # target rendered from a perturbed-albedo scene
    true_scene = scene._replace(
        albedo=scene.albedo.at[1].set(jnp.asarray([0.9, 0.1, 0.1]))
    )
    target = render_sharded(true_scene, cam, jax.random.PRNGKey(4), mesh)

    params, opt_state, step = make_sharded_train_step(
        scene, cam, mesh, spp=8, learning_rate=5e-2, trainable=("albedo",)
    )
    losses = []
    for it in range(25):
        params, opt_state, loss, grads = step(
            params, opt_state, jax.random.fold_in(jax.random.PRNGKey(5), it), target
        )
        losses.append(float(loss))
        for name, leaf in grads._asdict().items():
            assert np.all(np.isfinite(np.asarray(leaf))), name

    assert losses[-1] < losses[0], losses
    # albedo of sphere 1 moved toward the true red-ish albedo
    got = np.asarray(params.albedo[1])
    assert got[0] > 0.75 and got[1] < 0.25, got


# ---------------------------------------------------------------------------
# Sharded silhouette (edge-aware) training — round-4 VERDICT #5
# ---------------------------------------------------------------------------

def test_sharded_soft_step_runs_and_descends():
    """make_sharded_soft_train_step on the 8-device mesh: the silhouette
    estimator shards over rays/samples and a few steps recover a perturbed
    geometry direction (loss decreases, error shrinks)."""
    from raytracingproject_tpu.parallel.shard import make_sharded_soft_train_step

    true_scene = make_three_sphere_scene()
    wrong = true_scene._replace(
        center0=true_scene.center0.at[1].add(jnp.asarray([0.15, -0.1, 0.0])),
    )
    cam = small_camera(image_width=48, samples_per_pixel=4, max_depth=3)
    mesh = make_mesh(samples_axis_size=2)
    target = render_sharded(true_scene, cam, jax.random.PRNGKey(4), mesh)

    params, opt_state, step = make_sharded_soft_train_step(
        wrong, cam, mesh, spp=4, learning_rate=3e-2, softness=0.05,
        trainable=("center0",), candidates_k=4,
    )
    from raytracingproject_tpu.grad.inverse import SceneParams

    # update only the perturbed sphere: the soft estimator's O(softness)
    # value bias otherwise drifts the un-perturbed spheres and the HARD
    # target loss is not monotone (same masking as the cover-scale test)
    mask = SceneParams(
        center0=jnp.zeros_like(params.center0).at[1].set(1.0),
        center_delta=jnp.zeros_like(params.center_delta),
        radius=jnp.zeros_like(params.radius),
        albedo=jnp.zeros_like(params.albedo),
        fuzz=jnp.zeros_like(params.fuzz),
        ior=jnp.zeros_like(params.ior),
    )
    key = jax.random.PRNGKey(9)
    losses = []
    for i in range(25):
        params_new, opt_state, loss, grads = step(
            params, opt_state, jax.random.fold_in(key, i), target
        )
        params = jax.tree.map(
            lambda old, new, m: old + (new - old) * m, params, params_new, mask
        )
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    err0 = np.linalg.norm([0.15, -0.1, 0.0])
    err = np.linalg.norm(
        np.asarray(params.center0[1]) - np.asarray(true_scene.center0[1])
    )
    assert err < 0.7 * err0, (err, err0)


def test_sharded_soft_cover_scale_recovery_single_sphere():
    """Sharded twin of test_edge_grad.test_cover_scale_recovery_single_sphere
    (round-3 VERDICT next #5): the O(R*k) candidate estimator runs under
    shard_map at cover-scene scale (488 spheres) and improves a perturbed
    sphere's geometry. Shorter than the unsharded test (whose full recovery
    bounds are already pinned there); here the contract is that sharding
    preserves the estimator's direction at scale."""
    import optax

    from raytracingproject_tpu.config import RenderSettings
    from raytracingproject_tpu.grad.inverse import SceneParams
    from raytracingproject_tpu.parallel.shard import make_sharded_soft_train_step
    from raytracingproject_tpu.render import render
    from raytracingproject_tpu.scene import make_cover_scene

    scene = make_cover_scene(seed=0)
    n = int(scene.radius.shape[0])
    sphere = n - 2  # the big lambertian at (-4, 1, 0)
    cam = Camera(
        aspect_ratio=16.0 / 9.0, image_width=96, samples_per_pixel=2,
        max_depth=3, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.0, focus_dist=10.0,
    )
    target = render(scene, cam, jax.random.PRNGKey(0), RenderSettings())

    true_c = np.asarray(scene.center0[sphere]).copy()
    shift = np.array([0.0, -0.2, 0.25])
    wrong = scene._replace(
        center0=scene.center0.at[sphere].add(jnp.asarray(shift)),
    )
    mesh = make_mesh(samples_axis_size=2)
    params, opt_state, step = make_sharded_soft_train_step(
        wrong, cam, mesh, optimizer=optax.adam(2e-2), spp=2, softness=0.05,
        trainable=("center0",), candidates_k=8,
    )
    mask = SceneParams(
        center0=jnp.zeros_like(params.center0).at[sphere].set(1.0),
        center_delta=jnp.zeros_like(params.center_delta),
        radius=jnp.zeros_like(params.radius),
        albedo=jnp.zeros_like(params.albedo),
        fuzz=jnp.zeros_like(params.fuzz),
        ior=jnp.zeros_like(params.ior),
    )
    key = jax.random.PRNGKey(7)
    n_steps = 48
    for i in range(n_steps):
        w = 0.05 * (0.01 / 0.05) ** (i / max(n_steps - 1, 1))
        params_new, opt_state, loss, _ = step(
            params, opt_state, jax.random.fold_in(key, i), target, w
        )
        params = jax.tree.map(
            lambda old, new, m: old + (new - old) * m, params, params_new, mask
        )
    got_c = np.asarray(params.center0[sphere])
    # image-plane axes (y, z) carry the silhouette signal; both must move
    # meaningfully toward truth from the 0.2/0.25 perturbation
    err = np.abs(got_c - true_c)
    assert err[1] < 0.6 * 0.2, (got_c, true_c)
    assert err[2] < 0.6 * 0.25, (got_c, true_c)


# ---------------------------------------------------------------------------
# The megakernel under shard_map (interpreted on the virtual CPU mesh)
# ---------------------------------------------------------------------------

def test_render_sharded_megakernel_interpret():
    """render_sharded with the megakernel, interpreted as asked: finite, and
    statistically the XLA sharded render's image (whole-image mean within
    Z_MAX standard errors of the per-pixel differences)."""
    scene = make_three_sphere_scene()
    cam = small_camera(image_width=16, samples_per_pixel=8, max_depth=3)
    mesh = make_mesh(jax.devices()[:2], samples_axis_size=2)
    img_k = np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(0), mesh,
                                      use_megakernel=True, interpret=True))
    img_x = np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(1), mesh))
    assert img_k.shape == img_x.shape == (9, 16, 3)
    assert np.isfinite(img_k).all()
    from raytracingproject_tpu.validation import Z_MAX, region_z_scores

    z = region_z_scores(img_k, img_x, np.full(img_k.shape[:2], -2), min_count=100)
    assert z["all"] < Z_MAX, z


def test_sharded_train_step_megakernel_interpret():
    """make_sharded_train_step with the megakernel forward (interpreted) and
    replay backward: finite loss and gradients, albedo gradient nonzero."""
    scene = make_minimal_scene()
    cam = small_camera(image_width=16, samples_per_pixel=2, max_depth=2)
    mesh = make_mesh(jax.devices()[:2], samples_axis_size=1)
    target = jnp.full((9, 16, 3), 0.5)
    params, opt_state, step = make_sharded_train_step(
        scene, cam, mesh, spp=2, trainable=("albedo",), use_megakernel=True,
        interpret=True,
    )
    params, opt_state, loss, grads = step(params, opt_state,
                                          jax.random.PRNGKey(2), target)
    assert np.isfinite(float(loss))
    for name, leaf in grads._asdict().items():
        assert np.all(np.isfinite(np.asarray(leaf))), name
    assert np.abs(np.asarray(grads.albedo)).max() > 0
