"""Fast differentiable rendering: megakernel forward + path-replay backward.

The GPU megakernel (ops/pallas/megakernel.py) is forward-only — a Pallas
kernel has no automatic VJP. This module gives it one via jax.custom_vjp:

  forward  — the megakernel with in-kernel residual recording
             (pallas_trace_record);
  backward — reverse-mode through the O(depth)-per-ray path replay
             (grad/replay.py), never touching O(N_spheres) work again.

This closes SURVEY.md §7 build-plan step 5 ("custom VJPs for the Pallas
path"). Gradients flow to SceneParams only; ray origins/directions/times
receive zero cotangents (camera parameters are not trained — matches
grad/inverse.py's scope).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from raytracingproject_tpu.grad.inverse import SceneParams, apply_params
from raytracingproject_tpu.grad.replay import replay_radiance
from raytracingproject_tpu.scene import Scene


def make_fast_radiance(scene: Scene, max_depth: int, interpret: bool = False,
                       replay_groups: int = 1,
                       replay_skip_dead: bool | None = None,
                       replay_gather: str | None = None):
    """Build radiance_fn(params, origin, direction, time, seed_f32) -> [R,3]
    with the megakernel-forward / replay-backward custom VJP.

    `scene` supplies the non-differentiable topology (mat_type, array
    ordering). `interpret=True` runs the kernel in Pallas's interpreter
    (any backend); otherwise the backend must be the GPU.
    `seed_f32` is the PRNG seed as float32 (int seeds have no tangent type;
    it is rounded and cast in the forward).
    `replay_groups > 1` sorts rays by death depth and replays in that many
    slices so dead bounces are skipped per slice (replay_radiance's
    dead-depth skipping) — the lever that makes depth-50 backward cost
    ~the mean path length, not max_depth. Gradients agree to float
    precision (tests/test_replay.py asserts 2e-4 relative tolerance;
    cond-wrapped scans fuse differently, measured ~2.6e-5 rel).
    """
    from raytracingproject_tpu.ops.pallas.megakernel import (
        pallas_trace_paths, pallas_trace_record,
    )

    @jax.custom_vjp
    def radiance(params, origin, direction, time, seed_f32):
        s = apply_params(scene, params)
        seed = seed_f32.astype(jnp.int32)
        return pallas_trace_paths(
            origin, direction, time, s, seed, max_depth,
            interpret=interpret,
        )

    def fwd(params, origin, direction, time, seed_f32):
        s = apply_params(scene, params)
        seed = seed_f32.astype(jnp.int32)
        rad, res = pallas_trace_record(
            origin, direction, time, s, seed, max_depth,
            interpret=interpret,
        )
        return rad, (params, origin, direction, time, res)

    def bwd(saved, g):
        params, origin, direction, time, res = saved
        _, vjp = jax.vjp(
            lambda p: replay_radiance(p, scene, origin, direction, time, res,
                                      n_groups=replay_groups,
                                      skip_dead=replay_skip_dead,
                                      gather=replay_gather),
            params,
        )
        (g_params,) = vjp(g)
        return (
            g_params,
            jnp.zeros_like(origin),
            jnp.zeros_like(direction),
            jnp.zeros_like(time),
            jnp.zeros((), time.dtype),
        )

    radiance.defvjp(fwd, bwd)
    return radiance


def make_fast_train_step(
    scene: Scene,
    camera,
    optimizer=None,
    *,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    interpret: bool = False,
    replay_groups: int = 1,
    replay_skip_dead: bool | None = None,
    replay_gather: str | None = None,
):
    """Inverse-rendering train step on the fast path (grad/inverse.py's
    make_train_step with the megakernel forward + replay backward).

    Returns (params0, opt_state0, step) with
    step(params, opt_state, key, target_image) ->
        (params, opt_state, loss, grads)."""
    import optax

    from raytracingproject_tpu.camera import generate_rays
    from raytracingproject_tpu.grad.inverse import extract_params, trainable_mask

    optimizer = optimizer or optax.adam(learning_rate)
    if trainable is not None:
        mask = trainable_mask(trainable)
        labels = SceneParams(
            **{f: ("train" if getattr(mask, f) else "freeze")
               for f in SceneParams._fields}
        )
        optimizer = optax.multi_transform(
            {"train": optimizer, "freeze": optax.set_to_zero()}, labels
        )

    width, height = camera.image_size()
    cam = camera.derive(scene.center0.dtype)
    max_depth = camera.max_depth
    radiance_fn = make_fast_radiance(scene, max_depth, interpret=interpret,
                                     replay_groups=replay_groups,
                                     replay_skip_dead=replay_skip_dead,
                                     replay_gather=replay_gather)

    jj, ii = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    i_idx = jnp.tile(ii.reshape(-1), spp)
    j_idx = jnp.tile(jj.reshape(-1), spp)

    def loss_fn(params, key, target):
        k_ray, k_path = jax.random.split(key)
        o, d, t = generate_rays(cam, i_idx, j_idx, k_ray)
        seed = jax.random.randint(k_path, (), 0, 2**31 - 1).astype(jnp.float32)
        rad = radiance_fn(params, o, d, t, seed)
        img = rad.reshape(spp, height, width, 3).mean(axis=0)
        return jnp.mean((img - target) ** 2)

    @jax.jit
    def step(params, opt_state, key, target):
        loss, grads = jax.value_and_grad(loss_fn)(params, key, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    params0 = extract_params(scene)
    return params0, optimizer.init(params0), step
