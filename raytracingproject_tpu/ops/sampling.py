"""Counter-based random sampling (reference: src/vec3.h:121-147, src/rtweekend.h:25-34).

The reference draws from one global default-seeded mt19937 and uses
rejection sampling for disk/sphere points. Rejection loops with
data-dependent trip counts don't vectorize, so we use exact analytic
transforms of `jax.random` draws that produce the *same distributions*:

- unit disk:   r = sqrt(U), angle = 2*pi*U  (uniform over the disk)
- unit ball:   direction ~ uniform on S^2, radius = cbrt(U)
- unit sphere: normalized isotropic Gaussian

Parity with the reference is distributional, not bitwise (SURVEY.md design
stance) — golden tests pin our own fixed keys.

Every function takes a key and a batch `shape` and returns `shape + (3,)`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracingproject_tpu.ops.vecmath import dot


def random_in_unit_disk(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform points in the z=0 unit disk (src/vec3.h:121-127)."""
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k1, shape))
    theta = jax.random.uniform(k2, shape, minval=0.0, maxval=2.0 * jnp.pi)
    return jnp.stack(
        [r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1
    )


def random_unit_vector(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform directions on the unit sphere (src/vec3.h:137-139)."""
    g = jax.random.normal(key, shape + (3,))
    # Isotropic Gaussian normalized is uniform on S^2; the norm is ~0 with
    # probability 0 but guard anyway for float32.
    n = jnp.linalg.norm(g, axis=-1, keepdims=True)
    return g / jnp.maximum(n, 1e-12)


def random_in_unit_sphere(key: jax.Array, shape=()) -> jnp.ndarray:
    """Uniform points inside the unit ball (src/vec3.h:129-135)."""
    k1, k2 = jax.random.split(key)
    d = random_unit_vector(k1, shape)
    r = jnp.cbrt(jax.random.uniform(k2, shape))
    return d * r[..., None]


def random_on_hemisphere(key: jax.Array, normal: jnp.ndarray) -> jnp.ndarray:
    """Uniform directions on the hemisphere around `normal`
    (src/vec3.h:141-147). `normal` has shape (..., 3)."""
    v = random_unit_vector(key, normal.shape[:-1])
    same_side = dot(v, normal) > 0.0
    return jnp.where(same_side[..., None], v, -v)
