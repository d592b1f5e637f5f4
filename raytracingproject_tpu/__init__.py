"""raytracingproject_tpu — a differentiable path tracer for the GPU.

Brand-new JAX/XLA/Pallas framework reproducing the capabilities of the
reference ShuvalovIvan/RayTracingProject (a C++ "Ray Tracing in One Weekend"
CPU tracer + Vulkan compute renderer), redesigned for accelerators:

- Scene as a struct-of-arrays pytree (differentiable leaves) instead of the
  reference's virtual `hittable`/`material` class graph
  (reference: src/hittable_list.h, src/material.h).
- Radiance as `lax.scan` over bounce depth instead of recursion
  (reference: src/camera_cpu.h:8-26).
- Counter-based `jax.random` keys instead of a global mt19937
  (reference: src/rtweekend.h:25-34).
- A Pallas GPU megakernel (Triton route) for the whole bounce loop; the
  pure-jnp renderer is the differentiable correctness oracle.
- Multi-device scaling via `jax.sharding.Mesh` + `shard_map` (rays sharded,
  scene replicated, gradients psum-ed) — replacing the reference's
  single-GPU Vulkan queue machinery.
"""

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.scene import Scene, SceneBuilder, make_cover_scene
from raytracingproject_tpu.config import RenderSettings, LAMBERTIAN, METAL, DIELECTRIC
from raytracingproject_tpu.render import render, render_image, ray_color
from raytracingproject_tpu.session import RendererSession

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Scene",
    "SceneBuilder",
    "make_cover_scene",
    "RenderSettings",
    "LAMBERTIAN",
    "METAL",
    "DIELECTRIC",
    "render",
    "render_image",
    "ray_color",
    "RendererSession",
    "__version__",
]
