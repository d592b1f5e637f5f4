"""Renderer session — the JAX analog of the reference's environment API.

`RayTracingProject::GraphicalEnvironment` (src/graphical_environment.h:17-32)
exposes init / load_preconfigured_shapes / add_spheres / add_texture /
start_interactive_loop. Here the Vulkan device/swapchain/pipeline machinery
(src/vulkan/graphical_environment_vulkan.cpp:21-175) collapses into JAX
device discovery + jit compilation; "presenting a frame" becomes producing an
image array (and optionally writing a PPM). Frame pipelining
(max_frames_in_flight=2, src/common_objects.h:10) maps to JAX async dispatch:
up to `max_frames_in_flight` device computations are left in flight before
blocking on the oldest.
"""

from __future__ import annotations

import dataclasses
import logging
import time as _time
from collections import deque
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.config import RenderSettings
from raytracingproject_tpu.render import render
from raytracingproject_tpu.scene import Scene, SceneBuilder

log = logging.getLogger("raytracingproject_tpu")


class SessionError(RuntimeError):
    """Raised on misuse — the analog of LOG_AND_THROW
    (src/graphical_environment.h:10-11)."""


def _log_and_throw(msg: str) -> None:
    log.error(msg)
    raise SessionError(msg)


class Sphere(NamedTuple):
    """GPU-facing sphere POD (reference: src/common_objects.h:17-22:
    {vec3 center; float radius; vec4 color}). Spheres added through the
    session API become Lambertians with albedo = color.rgb."""

    center: tuple
    radius: float
    color: tuple = (1.0, 1.0, 1.0, 1.0)


# Capacity of the session sphere buffer, matching the reference's
# DataBuffer<Sphere, 200> (src/vulkan/graphical_environment_vulkan.h:141).
SPHERE_CAPACITY = 200


def orbit_camera(camera: Camera, angle_deg: float) -> Camera:
    """Camera rotated `angle_deg` around `lookat` about the `vup` axis.

    The analog of the reference's animated model matrix
    (glm::rotate(mat4(1), time * radians(90), vec3(0,0,1)),
    src/vulkan/graphical_environment_vulkan.cpp:374-391): rotating the scene
    under a fixed camera equals orbiting the camera around the scene, and
    the latter keeps the scene arrays (the expensive upload) untouched.
    Host-side float64 Rodrigues rotation; only CameraDerived's traced arrays
    change, so the compiled render pipeline is reused across frames.
    """
    lookfrom = np.asarray(camera.lookfrom, np.float64)
    lookat = np.asarray(camera.lookat, np.float64)
    axis = np.asarray(camera.vup, np.float64)
    axis = axis / np.linalg.norm(axis)
    rel = lookfrom - lookat
    th = np.radians(angle_deg)
    rot = (
        rel * np.cos(th)
        + np.cross(axis, rel) * np.sin(th)
        + axis * np.dot(axis, rel) * (1.0 - np.cos(th))
    )
    return dataclasses.replace(camera, lookfrom=tuple(lookat + rot))


class RendererSession:
    """Stateful renderer session implementing the Layer-B interface
    (src/graphical_environment.h:17-32) on the JAX runtime.

    Unlike the reference (where `append` after init never re-uploads and the
    sphere SSBO is never bound — src/vulkan/data_buffer.h:47-52,
    descriptors_manager.h:26-36), spheres added here at any time are rendered:
    the scene is padded to a static capacity so re-uploads don't recompile.
    """

    def __init__(
        self,
        settings: RenderSettings | None = None,
        camera: Camera | None = None,
        animate_deg_per_s: float = 0.0,
    ) -> None:
        """`animate_deg_per_s` is the per-frame animation analog of the
        reference's time-rotating model matrix (update_uniform_buffer,
        src/vulkan/graphical_environment_vulkan.cpp:374-391, which spins the
        scene at 90 deg/s of wall-clock time): the camera orbits `lookat`
        about `vup` at that rate, so successive frames view the scene from a
        rotating angle. Set 90.0 to match the reference's rate. The orbit
        only changes traced camera arrays (CameraDerived), so animated
        frames reuse the compiled pipeline — no per-frame re-jit."""
        self.settings = settings or RenderSettings()
        self.animate_deg_per_s = animate_deg_per_s
        self._anim_start: float | None = None
        self.camera = camera or Camera(
            aspect_ratio=self.settings.width / self.settings.height,
            image_width=self.settings.width,
            samples_per_pixel=4,
            max_depth=8,
            vfov=60.0,
            lookfrom=(0.0, 0.0, 4.0),
            lookat=(0.0, 0.0, 0.0),
        )
        self._builder = SceneBuilder()
        self._spheres_added = 0
        self._texture: np.ndarray | None = None
        self._initialized = False
        self._frame_index = 0
        self._inflight: deque = deque()
        self._last_frame: np.ndarray | None = None

    # -- lifecycle ---------------------------------------------------------

    def enable_validation(self) -> None:
        """Validation-layer analog (reference enables Khronos validation +
        debug messenger, graphical_environment_vulkan.cpp:17,
        validation.h:29-49): turns on jax NaN/inf checking so any
        non-finite value raises at the op that produced it."""
        jax.config.update("jax_debug_nans", True)
        log.info("validation enabled: jax_debug_nans")

    def resize(self, width: int, height: int) -> None:
        """Swapchain-recreation analog (VK_ERROR_OUT_OF_DATE_KHR path,
        graphical_environment_vulkan.cpp:404-414): rebuild the camera for
        the new extent; the next draw_frame re-jits for the new shapes and
        rendering continues."""
        if width <= 0 or height <= 0:
            _log_and_throw(f"invalid extent {width}x{height}")
        self.settings = dataclasses.replace(self.settings, width=width, height=height)
        self.camera = dataclasses.replace(
            self.camera,
            aspect_ratio=width / height,
            image_width=width,
        )
        # drop in-flight frames rendered at the old extent (the reference
        # recreates swapchain images the same way)
        self._inflight.clear()
        log.info("resized to %dx%d; pipelines will re-jit on next frame", width, height)

    def init(self) -> None:
        """Device discovery + warmup — replaces instance/surface/device/
        swapchain/pipeline bring-up (src/vulkan/graphical_environment_vulkan.cpp:21-106)."""
        from raytracingproject_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        devices = jax.devices()
        if not devices:
            _log_and_throw("no JAX devices available")
        log.info("RendererSession.init: %d device(s): %s", len(devices), devices)
        self._initialized = True

    def load_preconfigured_shapes(self) -> None:
        """Reference loads 3 shader sets here
        (src/vulkan/graphical_environment_vulkan.h:73-80); our pipelines are
        jitted on first use, so this seeds the default demo spheres instead
        (the two spheres the Vulkan test adds, tests/vulkan_tests.cpp:16-21)."""
        self.add_spheres(
            [
                Sphere(center=(0.0, 0.0, -2.0), radius=1.0, color=(0.9, 0.2, 0.2, 1.0)),
                Sphere(center=(1.5, 0.5, -2.5), radius=0.5, color=(0.2, 0.9, 0.2, 1.0)),
            ]
        )

    def add_spheres(self, spheres: Sequence[Sphere]) -> None:
        """Append spheres (src/graphical_environment.h:27,
        graphical_environment_vulkan.cpp:416-421). Capacity-limited like
        DataBuffer<Sphere,200>; excess raises instead of silently dropping."""
        if self._spheres_added + len(spheres) > SPHERE_CAPACITY:
            _log_and_throw(
                f"sphere buffer overflow: {self._spheres_added}+{len(spheres)} > {SPHERE_CAPACITY}"
            )
        for s in spheres:
            self._builder.add_lambertian(s.center, s.radius, tuple(s.color[:3]))
        self._spheres_added += len(spheres)

    def add_texture(self, path: str) -> None:
        """Load an image asset (src/graphical_environment.h:29, stb-based
        Texture src/vulkan/texture.cpp:9-43). Accepts PPM natively; other
        formats via PIL when available.

        The loaded texture becomes the ENVIRONMENT MAP: subsequent frames
        sample it (equirectangular, bilinear) for the sky radiance on ray
        miss instead of the default gradient — the path-tracing equivalent
        of the reference's sampled-and-displayed texture (its frag shader
        binding 1, SURVEY.md §3.3). Stored u8 values are decoded to linear
        radiance by inverting the sqrt gamma of src/color.h:9-12."""
        p = Path(path)
        if not p.exists():
            _log_and_throw(f"texture not found: {path}")
        if p.suffix.lower() == ".ppm":
            from raytracingproject_tpu.utils.ppm import read_ppm

            self._texture = read_ppm(p)
            return
        try:
            from PIL import Image  # optional

            self._texture = np.asarray(Image.open(p).convert("RGB"))
        except ImportError:
            log.warning("PIL unavailable; texture %s recorded but not decoded", path)
            self._texture = None

    # -- frame loop --------------------------------------------------------

    def scene(self) -> Scene:
        if self._spheres_added == 0:
            _log_and_throw("no spheres added")
        return self._builder.build(self.settings.dtype).pad_to(SPHERE_CAPACITY)

    def draw_frame(self) -> None:
        """Render one frame asynchronously. Mirrors the two-phase
        draw_frame (graphical_environment_vulkan.cpp:222-225): dispatch is
        async (compute submit), and we block on the oldest in-flight frame
        once `max_frames_in_flight` are queued (the fence wait,
        .cpp:232/308)."""
        if not self._initialized:
            _log_and_throw("init() not called")
        key = jax.random.PRNGKey(self._frame_index)
        sky = None
        if self._texture is not None:
            # u8 -> linear radiance (invert the sqrt gamma of src/color.h:9-12)
            sky = (jnp.asarray(self._texture, jnp.float32) / 255.0) ** 2
        cam = self.camera
        if self.animate_deg_per_s:
            now = _time.monotonic()
            if self._anim_start is None:
                self._anim_start = now
            angle = (now - self._anim_start) * self.animate_deg_per_s
            cam = orbit_camera(cam, angle)
        img = render(self.scene(), cam, key, self.settings, sky_texture=sky)
        self._inflight.append(img)
        self._frame_index += 1
        while len(self._inflight) > self.settings.max_frames_in_flight:
            oldest = self._inflight.popleft()
            self._last_frame = np.asarray(oldest)  # blocks (fence wait)

    def start_interactive_loop(self, duration_ms: int = 3000, max_frames: int | None = None) -> int:
        """Render frames for `duration_ms` (src/graphical_environment.h:31,
        graphical_environment_vulkan.cpp:208-220). Returns frames rendered."""
        start = _time.monotonic()
        frames = 0
        while (_time.monotonic() - start) * 1000.0 < duration_ms:
            self.draw_frame()
            frames += 1
            if max_frames is not None and frames >= max_frames:
                break
        self.flush()
        return frames

    def flush(self) -> np.ndarray | None:
        """Drain in-flight frames (vkDeviceWaitIdle analog,
        graphical_environment_vulkan.h:88)."""
        while self._inflight:
            self._last_frame = np.asarray(self._inflight.popleft())
        return self._last_frame

    @property
    def last_frame(self) -> np.ndarray | None:
        return self._last_frame

    def dump_device_info(self) -> str:
        """Device capability dump (graphical_environment_vulkan.cpp:192-206
        prints memory heaps). Returns a human-readable summary."""
        lines = []
        for d in jax.devices():
            stats = {}
            try:
                stats = d.memory_stats() or {}
            except Exception:  # backend may not support it
                pass
            lines.append(
                f"{d.platform}:{d.id} {getattr(d, 'device_kind', '?')} "
                f"bytes_in_use={stats.get('bytes_in_use', '?')} "
                f"bytes_limit={stats.get('bytes_limit', '?')}"
            )
        info = "\n".join(lines)
        log.info("device info:\n%s", info)
        return info
