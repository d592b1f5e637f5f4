"""Gradient tests: finite-difference allclose (BASELINE.md target) with
matched RNG keys, analytic checks, NaN-freedom, and inverse-rendering
convergence."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.grad.inverse import (
    SceneParams,
    extract_params,
    apply_params,
    render_loss,
    make_train_step,
)
from raytracingproject_tpu.render import render_pass, ray_color
from raytracingproject_tpu.scene import (
    SceneBuilder,
    make_three_sphere_scene,
    make_cover_scene,
)


def tiny_camera(**overrides):
    kw = dict(
        aspect_ratio=1.0,
        image_width=24,
        samples_per_pixel=8,
        max_depth=4,
        vfov=50.0,
        lookfrom=(0.0, 0.0, 2.0),
        lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.0,
    )
    kw.update(overrides)
    return Camera(**kw)


def single_sphere_scene(albedo=(0.6, 0.3, 0.2)):
    return SceneBuilder().add_lambertian((0.0, 0.0, 0.0), 0.7, albedo).build()


def mean_image(scene, cam, key, spp=8):
    return (
        render_pass(
            scene,
            cam.derive(),
            key,
            width=cam.image_width,
            height=cam.image_height,
            max_depth=cam.max_depth,
            spp_chunk=spp,
        )
        / spp
    )


def test_albedo_gradient_analytic():
    """One lambertian sphere, depth 2: every hitting ray contributes
    albedo * sky(scatter_dir), so d(sum of red channel)/d(albedo_red) equals
    sum of sky-red over hitting rays — i.e. the gradient equals the rendered
    red image with albedo_red := 1. Fixed key makes this exact."""
    cam = tiny_camera(max_depth=2)
    key = jax.random.PRNGKey(0)

    def red_sum(albedo_red):
        scene = single_sphere_scene(
            albedo=(0.0, 0.0, 0.0)
        )._replace(albedo=jnp.asarray([[albedo_red, 0.2, 0.2]]))
        return mean_image(scene, cam, key)[..., 0].sum()

    g = jax.grad(red_sum)(0.6)
    # linear in albedo_red -> slope = (f(1) - f(0)) exactly
    slope = red_sum(1.0) - red_sum(0.0)
    np.testing.assert_allclose(float(g), float(slope), rtol=1e-4)


@pytest.mark.parametrize(
    "field,idx,eps,tol,interior_only",
    [
        ("albedo", (1, 0), 1e-3, 0.05, False),
        ("radius", (1,), 1e-3, 0.05, True),
        ("center0", (1, 2), 1e-3, 0.05, True),
    ],
)
def test_grad_matches_finite_difference(field, idx, eps, tol, interior_only):
    """Central finite differences with a matched key.

    Geometry params (radius, center) use an interior-pixel window at
    max_depth=2: our gradient is the reparameterized-hit-distance estimator
    WITHOUT edge-aware silhouette terms (grad/inverse.py docstring), so FD
    across silhouette pixels — and across *secondary-bounce* path flips at
    deeper depths — measures discontinuous terms the estimator deliberately
    omits. At depth 2 in the window the primary hit (point, normal, scatter,
    sky) is fully smooth and FD must match tightly. Material params keep the
    full image and depth 5; their tolerances are loose where discrete
    decisions (Schlick branch, metal absorb) can flip for a handful of
    rays."""
    scene = make_three_sphere_scene()
    depth = 2 if interior_only else 5
    cam = tiny_camera(image_width=32, max_depth=depth, lookfrom=(0, 0.3, 2.5), lookat=(0, 0, -1))
    key = jax.random.PRNGKey(1)
    params = extract_params(scene)

    h, w = cam.image_height, cam.image_width
    if interior_only:
        # central window: interior of sphere 1's projection (it fills the
        # image center from this camera), away from its silhouette
        mask = np.zeros((h, w, 3))
        mask[h // 2 - 3 : h // 2 + 3, w // 2 - 3 : w // 2 + 3, :] = 1.0
    else:
        mask = np.ones((h, w, 3))
    weights = jnp.asarray(mask * np.cos(np.arange(mask.size).reshape(mask.shape)))

    def loss(p):
        img = mean_image(apply_params(scene, p), cam, key, spp=16)
        return jnp.sum(img * weights)

    g = jax.grad(loss)(params)
    g_val = float(getattr(g, field)[idx])

    def perturb(delta):
        arr = getattr(params, field)
        arr = arr.at[idx].add(delta)
        return params._replace(**{field: arr})

    f_plus = float(loss(perturb(eps)))
    f_minus = float(loss(perturb(-eps)))
    fd = (f_plus - f_minus) / (2 * eps)

    denom = max(abs(fd), abs(g_val), 1e-3)
    assert abs(g_val - fd) / denom < tol, (field, idx, g_val, fd)


def test_fuzz_grad_matches_finite_difference():
    """Fuzz FD on a smooth configuration: single metal sphere, depth 2,
    interior window. Radiance = albedo * sky(reflected + fuzz*ball_sample)
    is smooth in fuzz wherever the hemisphere test doesn't flip; at depth 5
    on the multi-material scene, per-ray absorb flips make image-level FD
    measure O(1) jumps the stop-gradient estimator deliberately omits."""
    scene = SceneBuilder().add_metal((0.0, 0.0, 0.0), 0.7, (0.8, 0.7, 0.6), fuzz=0.3).build()
    cam = tiny_camera(image_width=32, max_depth=2, lookfrom=(0, 0, 2.0), lookat=(0, 0, 0))
    key = jax.random.PRNGKey(4)
    params = extract_params(scene)
    h, w = cam.image_height, cam.image_width
    mask = np.zeros((h, w, 3))
    mask[h // 2 - 4 : h // 2 + 4, w // 2 - 4 : w // 2 + 4, :] = 1.0
    weights = jnp.asarray(mask)

    def loss(p):
        img = mean_image(apply_params(scene, p), cam, key, spp=16)
        return jnp.sum(img * weights)

    g = float(jax.grad(loss)(params).fuzz[0])
    eps = 1e-3
    fd = (
        float(loss(params._replace(fuzz=params.fuzz.at[0].add(eps))))
        - float(loss(params._replace(fuzz=params.fuzz.at[0].add(-eps))))
    ) / (2 * eps)
    denom = max(abs(fd), abs(g), 1e-3)
    assert abs(g - fd) / denom < 0.05, (g, fd)


def test_ior_grad_unit_level():
    """IOR gradients validated at the unit level: `refract` and Schlick are
    the only smooth channels through which ior affects radiance (the
    reflect-vs-refract *choice* is discrete and stop-gradient by design, so
    image-level FD is dominated by branch flips and does not estimate the
    smooth-path gradient)."""
    from raytracingproject_tpu.ops.vecmath import refract
    from raytracingproject_tpu.materials import schlick_reflectance

    uv = jnp.asarray([np.sin(0.4), -np.cos(0.4), 0.0])
    n = jnp.asarray([0.0, 1.0, 0.0])

    def out_x(ratio):
        return refract(uv[None], n[None], ratio)[0, 0]

    for ratio in [1 / 1.5, 1 / 1.2, 1.1]:
        g = float(jax.grad(out_x)(ratio))
        eps = 1e-4
        fd = (float(out_x(ratio + eps)) - float(out_x(ratio - eps))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-3)

    def schlick(ior):
        return schlick_reflectance(jnp.cos(0.4), 1.0 / ior)

    g = float(jax.grad(schlick)(1.5))
    eps = 1e-4
    fd = (float(schlick(1.5 + eps)) - float(schlick(1.5 - eps))) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=1e-3)


def test_cover_scene_grad_finite():
    """Full cover scene (~480 spheres incl. moving + all materials): the
    gradient of a small render must be finite everywhere (double-where
    discipline holds at scale)."""
    scene = make_cover_scene(seed=0)
    cam = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=40,
        samples_per_pixel=4,
        max_depth=8,
        vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6,
        focus_dist=10.0,
    )
    params = extract_params(scene)

    def loss(p):
        return jnp.mean(mean_image(apply_params(scene, p), cam, jax.random.PRNGKey(2), spp=4))

    g = jax.grad(loss)(params)
    for name, leaf in g._asdict().items():
        assert np.all(np.isfinite(np.asarray(leaf))), f"non-finite grad in {name}"
    # and the gradient is not identically zero
    total = sum(float(jnp.sum(jnp.abs(l))) for l in g)
    assert total > 0


def test_inverse_rendering_recovers_albedo():
    """Benchmark config 4 smoke: recover a sphere albedo from a target
    image by gradient descent."""
    true_scene = single_sphere_scene(albedo=(0.8, 0.2, 0.5))
    cam = tiny_camera(max_depth=3)
    key = jax.random.PRNGKey(3)
    target = mean_image(true_scene, cam, key, spp=32)

    start_scene = single_sphere_scene(albedo=(0.4, 0.4, 0.4))
    opt_state, step = make_train_step(
        start_scene, cam, spp=16, learning_rate=5e-2, trainable=("albedo",)
    )
    params = extract_params(start_scene)

    losses = []
    for i in range(60):
        params, opt_state, loss, _ = step(
            params, opt_state, jax.random.fold_in(key, i), target
        )
        losses.append(float(loss))

    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    got = np.asarray(params.albedo[0])
    np.testing.assert_allclose(got, [0.8, 0.2, 0.5], atol=0.08)
