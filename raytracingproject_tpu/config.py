"""Configuration dataclasses.

Mirrors the reference's two config surfaces so settings transfer 1:1:
- `GraphicalEnvironmentSettings` POD (reference: src/common_objects.h:9-15)
  -> `RenderSettings` here (same field names and defaults where meaningful).
- Camera public fields (reference: src/camera.h:15-26) -> `Camera` dataclass
  in camera.py.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# Material type codes for the SoA scene (replaces the reference's
# lambertian/metal/dielectric subclasses, src/material.h:16-81).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

# Shadow-acne epsilon: the reference intersects over interval(0.001, inf)
# (src/camera_cpu.h:15). Kept at the same value; in float32 this is still a
# safe bound for the scene scales the reference uses (unit spheres, r=1000
# ground sphere viewed from ~13 units away).
T_MIN = 1e-3
T_MAX = jnp.inf


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Renderer session settings (reference: src/common_objects.h:9-15).

    `width`/`height`/`max_frames_in_flight`/`sphere_count` keep the reference
    defaults. Renderer knobs are appended.
    """

    max_frames_in_flight: int = 2
    max_images: int = 2
    width: int = 1024
    height: int = 768
    sphere_count: int = 20

    # renderer additions
    dtype: jnp.dtype = jnp.float32
    # Rays processed per device batch in the megakernel renderer. Static so
    # XLA compiles once; pixels*spp are chunked to this size.
    rays_per_batch: int = 1 << 17
    # Run the whole bounce loop in one GPU kernel (ops/pallas/megakernel.py;
    # forward-only — gradients use the XLA renderer or grad/fast.py). Needs
    # a GPU backend (render raises elsewhere), brute-force closest hit only
    # (render raises with use_bvh), and always computes float32 regardless
    # of `dtype`.
    use_megakernel: bool = False
    # Use the XLA BVH traversal instead of the brute-force closest-hit scan.
    use_bvh: bool = False
    # Max primitives per BVH leaf (the XLA traversal's leaf cost is a
    # [R, L] gather).
    bvh_leaf_size: int = 4
    # Host-sync the accumulator every N sample chunks. Bounds the device
    # queue depth; 2 in-flight chunks (the reference's max_frames_in_flight,
    # src/common_objects.h:10) are enough overlap.
    sync_every: int = 4
