"""Material scatter rules (reference: src/material.h).

The reference's virtual `material::scatter` dispatch becomes branch-free
masked selects over `mat_type`: all three scatter directions are computed for
every ray and the right one selected. On SIMD hardware this is cheaper than
divergent control flow — all lanes run anyway, and each rule is a handful of
elementwise ops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracingproject_tpu.config import LAMBERTIAN, METAL, DIELECTRIC
from raytracingproject_tpu.ops.vecmath import dot, normalize, reflect, refract
from raytracingproject_tpu.ops.sampling import random_unit_vector, random_in_unit_sphere
from raytracingproject_tpu.ops.intersect import HitRecord
from raytracingproject_tpu.scene import Scene


class ScatterResult(NamedTuple):
    direction: jnp.ndarray    # [R, 3] scattered ray direction
    attenuation: jnp.ndarray  # [R, 3]
    scattered: jnp.ndarray    # [R] bool — False = absorbed (black)
    # [R] bool — dielectric took the reflect branch (TIR or Schlick). Only
    # meaningful for dielectric lanes; recorded by the path-replay backward
    # (grad/replay.py) so the branch can be replayed as a constant decision.
    dielectric_reflected: jnp.ndarray


def schlick_reflectance(cosine: jnp.ndarray, ref_idx: jnp.ndarray) -> jnp.ndarray:
    """Schlick's approximation (src/material.h:74-79)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(
    key: jax.Array,
    in_direction: jnp.ndarray,  # [R, 3] incident ray direction (unnormalized)
    rec: HitRecord,
    scene: Scene,
) -> ScatterResult:
    """Batched scatter for all three material types (src/material.h:16-81).

    Scattered rays keep the incident ray's time (src/material.h:22,38,69) —
    handled by the caller, which threads `time` through unchanged.
    """
    k_lam, k_fuzz, k_refl = jax.random.split(key, 3)
    shape = rec.t.shape

    mat = jnp.take(scene.mat_type, rec.idx)
    albedo = jnp.take(scene.albedo, rec.idx, axis=0)
    fuzz = jnp.take(scene.fuzz, rec.idx)
    ior = jnp.take(scene.ior, rec.idx)

    unit_dir = normalize(in_direction, eps=1e-12)

    # --- lambertian (src/material.h:19-25): normal + random unit vector.
    # The reference deliberately omits the near_zero degenerate fix; we match.
    lam_dir = rec.normal + random_unit_vector(k_lam, shape)

    # --- metal (src/material.h:36-41): mirror of the *unit* incident dir
    # + fuzz * point-in-unit-sphere; absorbed if it leaves the hemisphere.
    reflected = reflect(unit_dir, rec.normal)
    metal_dir = reflected + fuzz[..., None] * random_in_unit_sphere(k_fuzz, shape)
    metal_ok = dot(metal_dir, rec.normal) > 0.0

    # --- dielectric (src/material.h:55-71): refract unless TIR or Schlick
    # says reflect; attenuation fixed at (1,1,1).
    ratio = jnp.where(rec.front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(dot(-unit_dir, rec.normal), 1.0)
    # Grad-safe sqrt at cos==1 (head-on rays): double-where.
    s2 = 1.0 - cos_theta * cos_theta
    s2_pos = s2 > 0.0
    sin_theta = jnp.where(s2_pos, jnp.sqrt(jnp.where(s2_pos, s2, 1.0)), 0.0)
    cannot_refract = ratio * sin_theta > 1.0
    reflect_prob = schlick_reflectance(cos_theta, ratio)
    do_reflect = cannot_refract | (reflect_prob > jax.random.uniform(k_refl, shape))
    diel_dir = jnp.where(
        do_reflect[..., None],
        reflect(unit_dir, rec.normal),
        refract(unit_dir, rec.normal, ratio),
    )

    is_lam = (mat == LAMBERTIAN)[..., None]
    is_metal = (mat == METAL)[..., None]
    direction = jnp.where(
        is_lam, lam_dir, jnp.where(is_metal, metal_dir, diel_dir)
    )
    attenuation = jnp.where(
        mat[..., None] == DIELECTRIC, jnp.ones_like(albedo), albedo
    )
    scattered = jnp.where(mat == METAL, metal_ok, True)
    return ScatterResult(
        direction=direction,
        attenuation=attenuation,
        scattered=scattered,
        dielectric_reflected=do_reflect,
    )
