"""Wavefront path tracing with stream compaction.

The megakernel (render.py) advances every camera sample through the bounce
loop in lockstep: after a few bounces most lanes are terminated but still
occupy vector lanes until the loop ends. This renderer keeps a fixed-capacity
ray *pool* that stays dense:

  1. free slots are refilled with fresh (pixel, sample) work items from a
     global queue (prefix-sum compaction over the free mask — the
     fixed-shape "stream compaction" of SURVEY.md §7),
  2. one bounce advances the whole pool,
  3. finished rays scatter their radiance into the pixel accumulator and
     free their slot.

Runs until the work queue drains and the pool empties (`lax.while_loop`),
so per-bounce compute scales with *live* rays, not pixels x spp x depth.
Forward-only (the megakernel scan remains the differentiable path).

Kept as a design alternative and CPU-runnable reference of the compaction
idea. Its per-bounce compaction (sort + gathers over the pool) runs in XLA,
outside the megakernel; its time on the GPU is not measured yet
(tools/bench_wavefront.py measures it).

RNG: each work item w = sample*npix + pixel uses fold_in(key, w) — fully
deterministic and independent of pool scheduling order.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracingproject_tpu.camera import Camera, CameraDerived
from raytracingproject_tpu.config import RenderSettings, T_MIN
from raytracingproject_tpu.materials import scatter
from raytracingproject_tpu.ops.intersect import closest_hit
from raytracingproject_tpu.ops.sampling import random_in_unit_disk
from raytracingproject_tpu.render import sky_color
from raytracingproject_tpu.scene import Scene


class _Pool(NamedTuple):
    origin: jnp.ndarray      # [C, 3]
    direction: jnp.ndarray   # [C, 3]
    time: jnp.ndarray        # [C]
    throughput: jnp.ndarray  # [C, 3]
    pixel: jnp.ndarray       # [C] int32 pixel id
    depth: jnp.ndarray       # [C] int32 bounces taken so far
    work: jnp.ndarray        # [C] int32 work item id (for RNG)
    alive: jnp.ndarray       # [C] bool


def _gen_rays_for(cam: CameraDerived, pixel: jnp.ndarray, work: jnp.ndarray,
                  width: int, base_key: jax.Array):
    """Per-work-item camera rays: jitter, defocus, time from fold_in(key, w)."""
    i = (pixel % width).astype(jnp.float32)
    j = (pixel // width).astype(jnp.float32)

    keys = jax.vmap(lambda w: jax.random.fold_in(base_key, w))(work)

    def draws(k):
        k1, k2, k3 = jax.random.split(k, 3)
        off = jax.random.uniform(k1, (2,), minval=-0.5, maxval=0.5)
        disk = random_in_unit_disk(k2)
        tm = jax.random.uniform(k3)
        return off, disk, tm

    off, disk, tm = jax.vmap(draws)(keys)

    pixel_center = (
        cam.pixel00_loc[None, :]
        + i[:, None] * cam.pixel_delta_u[None, :]
        + j[:, None] * cam.pixel_delta_v[None, :]
    )
    pixel_sample = (
        pixel_center
        + off[:, 0:1] * cam.pixel_delta_u[None, :]
        + off[:, 1:2] * cam.pixel_delta_v[None, :]
    )
    defocus_origin = (
        cam.center[None, :]
        + disk[:, 0:1] * cam.defocus_disk_u[None, :]
        + disk[:, 1:2] * cam.defocus_disk_v[None, :]
    )
    origin = jnp.where(cam.defocus_angle > 0.0, defocus_origin, cam.center[None, :])
    direction = pixel_sample - origin
    return origin, direction, tm


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "pool_size"),
)
def render_wavefront(
    scene: Scene,
    cam: CameraDerived,
    key: jax.Array,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    pool_size: int = 1 << 16,
) -> jnp.ndarray:
    """Wavefront render: radiance *sum* image [H, W, 3] (divide by spp for
    the mean, as src/color.h:20-22)."""
    npix = width * height
    total_work = npix * spp
    C = pool_size
    dtype = cam.center.dtype

    k_path, k_cam = jax.random.split(key)

    acc0 = jnp.zeros((npix, 3), dtype)
    pool0 = _Pool(
        origin=jnp.zeros((C, 3), dtype),
        direction=jnp.ones((C, 3), dtype),  # placeholder; not alive
        time=jnp.zeros((C,), dtype),
        throughput=jnp.zeros((C, 3), dtype),
        pixel=jnp.zeros((C,), jnp.int32),
        depth=jnp.zeros((C,), jnp.int32),
        work=jnp.zeros((C,), jnp.int32),
        alive=jnp.zeros((C,), bool),
    )

    def refill(pool, next_work):
        """Stream compaction: pack fresh work into free slots."""
        free = ~pool.alive
        # rank of each free slot among free slots (0-based)
        rank = jnp.cumsum(free.astype(jnp.int32)) - 1
        assign = free & (next_work + rank < total_work)
        work_id = jnp.where(assign, next_work + rank, 0).astype(jnp.int32)
        n_assigned = jnp.sum(assign.astype(jnp.int32))

        pixel = work_id % npix
        origin, direction, tm = _gen_rays_for(cam, pixel, work_id, width, k_cam)

        sel = assign[:, None]
        pool = _Pool(
            origin=jnp.where(sel, origin, pool.origin),
            direction=jnp.where(sel, direction, pool.direction),
            time=jnp.where(assign, tm, pool.time),
            throughput=jnp.where(sel, 1.0, pool.throughput),
            pixel=jnp.where(assign, pixel, pool.pixel),
            depth=jnp.where(assign, 0, pool.depth),
            work=jnp.where(assign, work_id, pool.work),
            alive=pool.alive | assign,
        )
        return pool, next_work + n_assigned

    def bounce(pool, acc, bounce_idx):
        rec = closest_hit(
            pool.origin, pool.direction, pool.time,
            scene.center0, scene.center_delta, scene.radius, t_min=T_MIN,
        )
        # per-ray scatter keys: fold work id then depth
        k = jax.random.fold_in(k_path, bounce_idx)
        sc = scatter(k, pool.direction, rec, scene)
        # NOTE: scatter() draws vectorized randomness keyed by pool position;
        # combined with fold_in(bounce counter) every (slot, iteration) pair
        # is unique, so streams never repeat.

        miss = pool.alive & ~rec.hit
        contrib = jnp.where(
            miss[:, None], pool.throughput * sky_color(pool.direction), 0.0
        )
        acc = acc.at[pool.pixel].add(contrib)

        hit_live = pool.alive & rec.hit
        new_depth = pool.depth + 1
        exhausted = new_depth >= max_depth  # depth-limited (src/camera_cpu.h:11-13)
        still = hit_live & sc.scattered & ~exhausted

        pool = pool._replace(
            origin=jnp.where(hit_live[:, None], rec.p, pool.origin),
            direction=jnp.where(hit_live[:, None], sc.direction, pool.direction),
            throughput=jnp.where(
                hit_live[:, None], pool.throughput * sc.attenuation, pool.throughput
            ),
            depth=new_depth,
            alive=still,
        )
        return pool, acc

    def cond(state):
        pool, acc, next_work, it = state
        return (next_work < total_work) | jnp.any(pool.alive)

    def body(state):
        pool, acc, next_work, it = state
        pool, next_work = refill(pool, next_work)
        pool, acc = bounce(pool, acc, it)
        return pool, acc, next_work, it + 1

    pool, acc, next_work, _ = jax.lax.while_loop(
        cond, body, (pool0, acc0, jnp.int32(0), jnp.int32(0))
    )
    return acc.reshape(height, width, 3)


def render_wavefront_image(
    scene: Scene,
    camera: Camera,
    key: jax.Array | None = None,
    settings: RenderSettings | None = None,
) -> jnp.ndarray:
    """Mean-radiance wavefront render [H, W, 3]."""
    settings = settings or RenderSettings()
    key = key if key is not None else jax.random.PRNGKey(0)
    width, height = camera.image_size()
    cam = camera.derive(settings.dtype)
    total = width * height * camera.samples_per_pixel
    pool = max(4096, min(settings.rays_per_batch, 1 << (total - 1).bit_length()))
    acc = render_wavefront(
        scene,
        cam,
        key,
        width=width,
        height=height,
        spp=camera.samples_per_pixel,
        max_depth=camera.max_depth,
        pool_size=pool,
    )
    return acc / camera.samples_per_pixel
