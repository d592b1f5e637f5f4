"""Ray-sphere and ray-AABB intersection (reference: src/sphere.h:30-57, src/aabb.h:35-53).

Batched over rays and spheres simultaneously; the closest-hit scan
(reference: src/hittable_list.h:25-39 shrinking `closest_so_far`) becomes a
masked argmin over the sphere axis, which XLA fuses with the quadratic math
(on an H100 no [R, N] intermediate reaches device memory — PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracingproject_tpu.config import T_MIN, T_MAX
from raytracingproject_tpu.ops.vecmath import dot


class HitRecord(NamedTuple):
    """SoA hit record (reference: src/hittable.h:12-22).

    All fields have a leading ray-batch axis. `idx` replaces the reference's
    `mat` pointer — material attributes are gathered from the scene SoA.
    """

    t: jnp.ndarray          # [R] hit distance (T_MAX where miss)
    idx: jnp.ndarray        # [R] int32 index of hit sphere (0 where miss)
    hit: jnp.ndarray        # [R] bool
    p: jnp.ndarray          # [R, 3] hit point
    normal: jnp.ndarray     # [R, 3] normal facing against the ray
    front_face: jnp.ndarray # [R] bool


def sphere_hit_t(
    origin: jnp.ndarray,   # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    center: jnp.ndarray,   # [R, N, 3] or [N, 3] (motion-blur centers are per-ray)
    radius: jnp.ndarray,   # [N]
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest valid root per (ray, sphere) pair (src/sphere.h:30-57).

    Returns (t [R, N], valid [R, N]); t is meaningful only where valid.
    The root test uses the *open* interval (`interval::surrounds`,
    src/interval.h:30-32), matching the reference exactly.
    """
    if center.ndim == 2:
        center = center[None, :, :]
    oc = origin[:, None, :] - center                      # [R, N, 3]
    # Degenerate lambertian scatter (normal + unit vector ~ 0; the reference
    # omits the near_zero fix, src/material.h:19-25) can yield |d|^2 == 0;
    # clamp so 0/0 can't produce NaN — tiny `a` makes both roots invalid,
    # i.e. a miss, which is the sensible limit.
    a = jnp.maximum(dot(direction, direction), 1e-20)[:, None]  # [R, 1]
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    half_b = jnp.einsum("rnc,rc->rn", oc, direction,
                        precision=jax.lax.Precision.HIGHEST)  # [R, N]
    c = dot(oc, oc) - radius[None, :] ** 2                # [R, N]

    disc = half_b * half_b - a * c
    # Grad-safety: sqrt at disc<=0 has an inf/NaN derivative that would leak
    # through `where` into d(pixel)/d(scene) cotangents (the double-where
    # rule). Invalid lanes get a finite dummy and are masked by `valid`.
    disc_pos = disc > 0.0
    sqrtd = jnp.sqrt(jnp.where(disc_pos, disc, 1.0))

    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    in0 = (root0 > t_min) & (root0 < t_max)
    in1 = (root1 > t_min) & (root1 < t_max)
    root = jnp.where(in0, root0, root1)
    valid = disc_pos & (in0 | in1)
    return root, valid


def closest_hit(
    origin: jnp.ndarray,     # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    time: jnp.ndarray,       # [R] motion-blur time in [0, 1)
    center0: jnp.ndarray,    # [N, 3]
    center_delta: jnp.ndarray,  # [N, 3] (center2 - center1; zeros if static)
    radius: jnp.ndarray,     # [N]
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> HitRecord:
    """Closest hit over all spheres (src/hittable_list.h:25-39).

    Moving-sphere centers lerp by ray time (src/sphere.h:68-72): the center
    seen by ray r is center0 + time_r * center_delta.
    """
    center = center0[None, :, :] + time[:, None, None] * center_delta[None, :, :]
    t_all, valid = sphere_hit_t(origin, direction, center, radius, t_min, t_max)
    t_masked = jnp.where(valid, t_all, T_MAX)
    idx = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)   # [R]
    t = jnp.take_along_axis(t_masked, idx[:, None], axis=-1)[:, 0]
    hit = jnp.isfinite(t)

    # Grad-safety: miss lanes carry t=inf; give them a finite dummy before
    # any arithmetic so inf/NaN can't reach masked-lane cotangents. `hit`
    # is the topology mask — discrete, so downstream consumers must treat
    # it as non-differentiable (stop-gradient discipline, SURVEY.md §7).
    t_safe = jnp.where(hit, t, 1.0)
    p = origin + t_safe[:, None] * direction
    hit_center = jnp.take(center0, idx, axis=0) + time[:, None] * jnp.take(
        center_delta, idx, axis=0
    )
    r_sel = jnp.take(radius, idx)
    r_safe = jnp.where(r_sel != 0.0, r_sel, 1.0)  # padded spheres have r=0
    outward = (p - hit_center) / r_safe[:, None]
    front_face = dot(direction, outward) < 0.0   # src/hittable.h:15-21
    normal = jnp.where(front_face[:, None], outward, -outward)
    return HitRecord(t=t, idx=idx, hit=hit, p=p, normal=normal, front_face=front_face)


def aabb_hit(
    origin: jnp.ndarray,     # [..., 3]
    direction: jnp.ndarray,  # [..., 3]
    box_min: jnp.ndarray,    # [..., 3]
    box_max: jnp.ndarray,    # [..., 3]
    t_min: float = T_MIN,
    t_max: float = T_MAX,
) -> jnp.ndarray:
    """Slab test (src/aabb.h:35-53), vectorized over all axes at once.

    Returns a bool mask. Division by zero direction components yields +/-inf
    which the min/max logic handles exactly as the reference's invD swap.
    """
    inv_d = 1.0 / direction
    t0 = (box_min - origin) * inv_d
    t1 = (box_max - origin) * inv_d
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    tmin = jnp.maximum(jnp.max(t_near, axis=-1), t_min)
    tmax = jnp.minimum(jnp.min(t_far, axis=-1), t_max)
    return tmax > tmin
