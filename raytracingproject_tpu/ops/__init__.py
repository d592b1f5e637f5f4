"""Core compute ops: vector math, sampling, intersection.

All ops are pure functions over batched arrays (SoA layout, last axis = xyz),
traceable under jit/vmap/grad — the batched replacement for the
reference's scalar `vec3` / `sphere::hit` / material classes.
"""

from raytracingproject_tpu.ops.vecmath import (
    dot,
    cross,
    length,
    length_squared,
    normalize,
    near_zero,
    reflect,
    refract,
)
from raytracingproject_tpu.ops.sampling import (
    random_in_unit_disk,
    random_in_unit_sphere,
    random_unit_vector,
    random_on_hemisphere,
)
from raytracingproject_tpu.ops.intersect import (
    sphere_hit_t,
    closest_hit,
    aabb_hit,
)

__all__ = [
    "dot",
    "cross",
    "length",
    "length_squared",
    "normalize",
    "near_zero",
    "reflect",
    "refract",
    "random_in_unit_disk",
    "random_in_unit_sphere",
    "random_unit_vector",
    "random_on_hemisphere",
    "sphere_hit_t",
    "closest_hit",
    "aabb_hit",
]
