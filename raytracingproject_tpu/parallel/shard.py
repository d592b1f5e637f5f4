"""Sharded rendering and training over a device mesh.

Layout (the BASELINE.json mandated strategy):
- pixels sharded over the `rays` mesh axis,
- spp sharded over the `samples` mesh axis (partial radiance sums psum-ed),
- scene/params replicated; gradient all-reduce emerges as XLA's transpose
  of the replicated-capture inside shard_map.

The collectives are small: the image/loss psums and the parameter-gradient
all-reduce (about 23 KB for the 488-sphere cover scene). Their time on the
GPU is not measured yet.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

import optax

from raytracingproject_tpu.camera import Camera, CameraDerived, generate_rays
from raytracingproject_tpu.grad.inverse import SceneParams, apply_params, extract_params
from raytracingproject_tpu.render import ray_color
from raytracingproject_tpu.scene import Scene


def _pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pixel_grid(width: int, height: int, pad_to: int):
    """Flattened pixel indices padded to a shardable length. Padding pixels
    re-render pixel (0,0) and are dropped on reshape."""
    jj, ii = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    i = ii.reshape(-1).astype(np.int32)
    j = jj.reshape(-1).astype(np.int32)
    total = _pad_to_multiple(i.size, pad_to)
    pad = total - i.size
    if pad:
        i = np.concatenate([i, np.zeros(pad, np.int32)])
        j = np.concatenate([j, np.zeros(pad, np.int32)])
    return jnp.asarray(i), jnp.asarray(j)


def _render_flat(
    scene: Scene,
    cam: CameraDerived,
    i: jnp.ndarray,
    j: jnp.ndarray,
    key: jax.Array,
    *,
    max_depth: int,
    spp_local: int,
    use_megakernel: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """Radiance sum over `spp_local` samples for a flat pixel batch [P].
    Samples loop via lax.scan to keep the live set at one wavefront.

    `use_megakernel` runs each shard's rays through the GPU megakernel;
    `interpret` runs it in Pallas's interpreter instead, so the same sharded
    program executes on a virtual CPU mesh (tests)."""

    def sample_pass(acc, k):
        k_ray, k_path = jax.random.split(k)
        origin, direction, time = generate_rays(cam, i, j, k_ray)
        if use_megakernel:
            from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_paths

            seed = jax.random.randint(k_path, (), 0, 2**31 - 1, dtype=jnp.int32)
            rad = pallas_trace_paths(
                origin, direction, time, scene, seed, max_depth,
                interpret=interpret,
            )
        else:
            rad = ray_color(scene, origin, direction, time, k_path, max_depth)
        return acc + rad, None

    acc = jnp.zeros((i.shape[0], 3), cam.center.dtype)
    keys = jax.random.split(key, spp_local)
    acc, _ = jax.lax.scan(sample_pass, acc, keys)
    return acc


def render_sharded(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    mesh: Mesh,
    spp: int | None = None,
    use_megakernel: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """Distributed render: mean radiance [H, W, 3].

    Pixels shard over `rays`; each samples-shard renders spp/n_samples
    samples and the partial sums are `psum`-ed over `samples` — the scene
    is replicated, and no pixel data ever moves between ray shards.
    `use_megakernel` needs GPU devices, or `interpret=True` (Pallas's
    interpreter, for CPU meshes).
    """
    width, height = camera.image_size()
    cam = camera.derive(scene.center0.dtype)
    spp = spp or camera.samples_per_pixel
    n_rays = mesh.shape["rays"]
    n_samples = mesh.shape["samples"]
    if spp % n_samples != 0:
        raise ValueError(f"spp {spp} not divisible by samples axis {n_samples}")
    spp_local = spp // n_samples
    max_depth = camera.max_depth

    i, j = _pixel_grid(width, height, n_rays)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P()),
        out_specs=P("rays", None),
        check_vma=False,
    )
    def shard_fn(scene, cam, i_loc, j_loc, key):
        ray_id = jax.lax.axis_index("rays")
        s_id = jax.lax.axis_index("samples")
        k = jax.random.fold_in(jax.random.fold_in(key, ray_id), s_id)
        acc = _render_flat(
            scene, cam, i_loc, j_loc, k, max_depth=max_depth,
            spp_local=spp_local, use_megakernel=use_megakernel,
            interpret=interpret,
        )
        return jax.lax.psum(acc, "samples")

    flat = shard_fn(scene, cam, i, j, key)
    return flat[: width * height].reshape(height, width, 3) / spp


def make_sharded_soft_train_step(
    scene: Scene,
    camera: Camera,
    mesh: Mesh,
    optimizer: optax.GradientTransformation | None = None,
    *,
    spp: int = 4,
    softness: float = 0.02,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    candidates_k: int | None = None,
):
    """Silhouette-gradient training sharded over the mesh (round-3 VERDICT
    missing/next #5): grad.edge.make_soft_train_step's estimator with loss
    pixels sharded over `rays` and samples over `samples`, the same
    psum-transpose gradient collective as make_sharded_train_step. The
    O(R*k) streaming top-k candidate selection (grad/edge.py) runs per
    shard on its own rays — candidate selection needs no cross-shard data,
    so the only collectives are the image/loss psums and the ~KB parameter
    gradient all-reduce.

    Returns (params0, opt_state0, step) with
    step(params, opt_state, key, target_image, softness_t=softness)."""
    from raytracingproject_tpu.grad.edge import soft_primary_radiance
    from raytracingproject_tpu.grad.inverse import trainable_mask

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
    n_rays = mesh.shape["rays"]
    n_samples = mesh.shape["samples"]
    if spp % n_samples != 0:
        raise ValueError(f"spp {spp} not divisible by samples axis {n_samples}")
    spp_local = spp // n_samples

    i, j = _pixel_grid(width, height, n_rays)
    npix = width * height

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P(), P("rays"), P()),
        out_specs=P(),
        check_vma=False,
    )
    def shard_loss(params, scene_in, i_loc, j_loc, key, target_loc, w):
        ray_id = jax.lax.axis_index("rays")
        s_id = jax.lax.axis_index("samples")
        k = jax.random.fold_in(jax.random.fold_in(key, ray_id), s_id)

        def sample_pass(acc, ks):
            k_ray, k_path = jax.random.split(ks)
            o, d, t = generate_rays(cam, i_loc, j_loc, k_ray)
            rad = soft_primary_radiance(
                params, scene_in, o, d, t, k_path, max_depth, w,
                candidates_k=candidates_k,
            )
            return acc + rad, None

        acc = jnp.zeros((i_loc.shape[0], 3), cam.center.dtype)
        acc, _ = jax.lax.scan(sample_pass, acc, jax.random.split(k, spp_local))
        img = jax.lax.psum(acc, "samples") / (spp_local * n_samples)
        sq = jnp.sum((img - target_loc) ** 2)
        return jax.lax.psum(sq, "rays") / (npix * 3)

    def loss_fn(params, key, target_flat, w):
        return shard_loss(params, scene, i, j, key, target_flat, w)

    @jax.jit
    def step(params, opt_state, key, target_image, softness_t=softness):
        target_flat = target_image.reshape(-1, 3)
        pad = i.shape[0] - target_flat.shape[0]
        target_flat = jnp.concatenate(
            [target_flat, jnp.broadcast_to(target_flat[0], (pad, 3))], axis=0
        )
        loss, grads = jax.value_and_grad(loss_fn)(
            params, key, target_flat, softness_t
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    params0 = extract_params(scene)
    return params0, optimizer.init(params0), step


def make_sharded_train_step(
    scene: Scene,
    camera: Camera,
    mesh: Mesh,
    optimizer: optax.GradientTransformation | None = None,
    *,
    spp: int = 8,
    learning_rate: float = 2e-2,
    trainable: tuple[str, ...] | None = None,
    use_megakernel: bool = False,
    interpret: bool = False,
):
    """Sharded inverse-rendering step (BASELINE config 5 training path).

    Loss pixels shard over `rays`, samples over `samples`; `jax.grad`
    transposes the shard_map so parameter gradients are automatically
    psum-ed across the whole mesh (a KB-scale collective — see the module
    docstring). Params/opt state are replicated.

    With `use_megakernel` each shard runs grad/fast.py's megakernel forward
    and path-replay backward on its own rays; the collective structure is
    unchanged. It needs GPU devices, or `interpret=True` (Pallas's
    interpreter, for CPU meshes).

    Returns (params0, opt_state0, step) with
    step(params, opt_state, key, target_image) ->
        (params, opt_state, loss, grads).
    """
    optimizer = optimizer or optax.adam(learning_rate)
    if trainable is not None:
        from raytracingproject_tpu.grad.inverse import trainable_mask

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
    n_rays = mesh.shape["rays"]
    n_samples = mesh.shape["samples"]
    if spp % n_samples != 0:
        raise ValueError(f"spp {spp} not divisible by samples axis {n_samples}")
    spp_local = spp // n_samples

    i, j = _pixel_grid(width, height, n_rays)
    npix = width * height
    fast_radiance = None
    if use_megakernel:
        # Pallas forward + path-replay backward (grad/fast.py), composed
        # with sharding: each ray shard records its own residuals and
        # replays its own backward; the parameter-gradient psum emerges
        # from the shard_map transpose exactly as in the XLA path.
        from raytracingproject_tpu.grad.fast import make_fast_radiance

        fast_radiance = make_fast_radiance(scene, max_depth,
                                           interpret=interpret)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("rays"), P("rays"), P(), P("rays")),
        out_specs=P(),
        check_vma=False,
    )
    def shard_loss(params, scene_in, i_loc, j_loc, key, target_loc):
        ray_id = jax.lax.axis_index("rays")
        s_id = jax.lax.axis_index("samples")
        k = jax.random.fold_in(jax.random.fold_in(key, ray_id), s_id)
        if use_megakernel:
            def sample_pass(acc, ks):
                k_ray, k_path = jax.random.split(ks)
                o, d, t = generate_rays(cam, i_loc, j_loc, k_ray)
                seed = jax.random.randint(k_path, (), 0, 2**31 - 1)
                acc = acc + fast_radiance(params, o, d, t, seed.astype(jnp.float32))
                return acc, None

            acc = jnp.zeros((i_loc.shape[0], 3), cam.center.dtype)
            acc, _ = jax.lax.scan(sample_pass, acc, jax.random.split(k, spp_local))
        else:
            s = apply_params(scene_in, params)
            acc = _render_flat(s, cam, i_loc, j_loc, k, max_depth=max_depth, spp_local=spp_local)
        img = jax.lax.psum(acc, "samples") / (spp_local * n_samples)
        # padding pixels carry target = rendered value -> zero residual
        sq = jnp.sum((img - target_loc) ** 2)
        return jax.lax.psum(sq, "rays") / (npix * 3)

    def loss_fn(params, key, target_flat):
        return shard_loss(params, scene, i, j, key, target_flat)

    @jax.jit
    def step(params, opt_state, key, target_image):
        target_flat = target_image.reshape(-1, 3)
        pad = i.shape[0] - target_flat.shape[0]
        # pad with zeros but mask: padded pixels all map to pixel (0,0);
        # replicate its target so the residual is genuine (counted once
        # extra per pad pixel — negligible and deterministic).
        target_flat = jnp.concatenate(
            [target_flat, jnp.broadcast_to(target_flat[0], (pad, 3))], axis=0
        )
        loss, grads = jax.value_and_grad(loss_fn)(params, key, target_flat)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, grads

    params0 = extract_params(scene)
    return params0, optimizer.init(params0), step
