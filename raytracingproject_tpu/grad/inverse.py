"""Inverse rendering: recover scene parameters from a target image.

Benchmark config 4 (BASELINE.md): pixel-loss gradients w.r.t. sphere
centers, radii, albedo, fuzz, and IOR. The reference has no counterpart —
this is an addition enabled by the megakernel renderer being a
pure differentiable function of the scene pytree.

Gradient formulation: hit distances are explicit smooth functions of the
geometry (reparameterized quadratic roots), so shading/position gradients
flow exactly; discrete topology (which sphere is hit, refract-vs-reflect,
metal absorption, hit/miss) is piecewise-constant w.r.t. parameters and
contributes no gradient (stop-gradient discipline at the masks). Silhouette
(edge) gradients are therefore omitted — adequate for recovering material
and moderate geometry perturbations; edge-aware estimators are future work.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.render import render_pass
from raytracingproject_tpu.scene import Scene


class SceneParams(NamedTuple):
    """The differentiable leaves of a Scene (everything but mat_type)."""

    center0: jnp.ndarray
    center_delta: jnp.ndarray
    radius: jnp.ndarray
    albedo: jnp.ndarray
    fuzz: jnp.ndarray
    ior: jnp.ndarray


def extract_params(scene: Scene) -> SceneParams:
    return SceneParams(
        center0=scene.center0,
        center_delta=scene.center_delta,
        radius=scene.radius,
        albedo=scene.albedo,
        fuzz=scene.fuzz,
        ior=scene.ior,
    )


def apply_params(scene: Scene, params: SceneParams) -> Scene:
    return scene._replace(**params._asdict())


@partial(jax.jit, static_argnames=("width", "height", "max_depth", "spp_chunk"))
def render_loss(
    params: SceneParams,
    scene: Scene,
    cam_derived,
    key: jax.Array,
    target: jnp.ndarray,  # [H, W, 3] linear radiance
    *,
    width: int,
    height: int,
    max_depth: int,
    spp_chunk: int,
) -> jnp.ndarray:
    """Mean-squared pixel loss between a `spp_chunk`-sample render and the
    target (linear space, pre-gamma)."""
    img = (
        render_pass(
            apply_params(scene, params),
            cam_derived,
            key,
            width=width,
            height=height,
            max_depth=max_depth,
            spp_chunk=spp_chunk,
        )
        / spp_chunk
    )
    return jnp.mean((img - target) ** 2)


def trainable_mask(trainable) -> SceneParams:
    """Boolean SceneParams mask selecting which fields receive updates.
    `trainable=None` trains everything."""
    fields = SceneParams._fields if trainable is None else tuple(trainable)
    unknown = set(fields) - set(SceneParams._fields)
    if unknown:
        raise ValueError(f"unknown trainable fields: {sorted(unknown)}")
    return SceneParams(**{f: f in fields for f in SceneParams._fields})


def make_train_step(
    scene: Scene,
    camera: Camera,
    optimizer: optax.GradientTransformation | None = None,
    *,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
):
    """Build (init_state, step) for inverse rendering.

    step(params, opt_state, key, target) -> (params, opt_state, loss, grads).
    `trainable` restricts updates to a subset of SceneParams fields (e.g.
    ("albedo",)) — without it, Adam's normalized first steps perturb every
    parameter (geometry included) by the full learning rate at once.
    The returned step is jittable and shardable (see parallel/shard.py for
    the mesh version with psum-ed gradients).
    """
    optimizer = optimizer or optax.adam(learning_rate)
    if trainable is not None:
        mask = trainable_mask(trainable)
        labels = SceneParams(
            **{f: ("train" if getattr(mask, f) else "freeze") for f in SceneParams._fields}
        )
        optimizer = optax.multi_transform(
            {"train": optimizer, "freeze": optax.set_to_zero()}, labels
        )
    width, height = camera.image_size()
    cam = camera.derive(scene.center0.dtype)
    max_depth = camera.max_depth

    loss_fn = partial(
        render_loss,
        scene=scene,
        cam_derived=cam,
        width=width,
        height=height,
        max_depth=max_depth,
        spp_chunk=spp,
    )

    @jax.jit
    def step(params: SceneParams, opt_state, key, target):
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(p, key=key, target=target)
        )(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    params0 = extract_params(scene)
    return optimizer.init(params0), step
