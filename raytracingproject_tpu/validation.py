"""Checks of the GPU megakernel against the XLA renderer, shared by the tests
(tests/test_gpu_lane.py on the card, interpret-mode tests on the CPU) and by
chip_smoke.py.

The megakernel draws other random numbers than render.ray_color, so its
images are compared statistically: per material region of the primary hit
(sky, lambertian, metal, dielectric) and over the whole image, the mean
difference of the two estimates must lie within Z_MAX standard errors, the
standard error taken from the spread of the per-sample (or per-pixel)
differences themselves. Monte-Carlo noise alone puts a region's z-score
above 5 with probability below 1e-6 per channel.

The path-replay backward (grad/replay.py) is checked exactly: replaying the
kernel's recorded residuals must rebuild the kernel's radiance, and replay
gradients must match reverse mode through render.ray_color.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from raytracingproject_tpu.config import DIELECTRIC, LAMBERTIAN, METAL
from raytracingproject_tpu.ops.intersect import closest_hit
from raytracingproject_tpu.scene import Scene

Z_MAX = 5.0
SE_FLOOR = 1e-5  # radiance units; float32 rounding of O(1) values is ~1e-7
REGIONS = {-1: "sky", LAMBERTIAN: "lambertian", METAL: "metal",
           DIELECTRIC: "dielectric"}
# Bounds of tests/test_replay.py: replay rebuilds the forward radiance to a
# relative error of 2e-4; replay gradients on the cover scene agree with
# full reverse mode to 5e-3 (relative norm, over rays whose replayed
# geometry is consistent — grazing rays whose closest hit differs by an ulp
# are excluded, as there).
REPLAY_RTOL = 2e-4
GRAD_RTOL = 5e-3


def material_labels(scene: Scene, origin, direction, time,
                    chunk: int = 1 << 15) -> np.ndarray:
    """Material of each ray's primary hit, -1 for sky: the region labels of
    the statistical comparison. Chunked so [R, N] intersections stay small."""
    hit_fn = jax.jit(lambda o, d, t: closest_hit(
        o, d, t, scene.center0, scene.center_delta, scene.radius))
    labels = []
    for s in range(0, origin.shape[0], chunk):
        rec = hit_fn(origin[s:s + chunk], direction[s:s + chunk],
                     time[s:s + chunk])
        mat = jnp.take(scene.mat_type, rec.idx)
        labels.append(np.asarray(jnp.where(rec.hit, mat, -1)))
    return np.concatenate(labels)


def pixel_material_labels(scene: Scene, camera) -> np.ndarray:
    """material_labels of the rays from the lens centre through the pixel
    centres at time 0, [H*W] row-major."""
    w, h = camera.image_size()
    cam = camera.derive()
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    target = (cam.pixel00_loc[None, :]
              + jnp.asarray(ii.reshape(-1, 1), jnp.float32) * cam.pixel_delta_u
              + jnp.asarray(jj.reshape(-1, 1), jnp.float32) * cam.pixel_delta_v)
    origin = jnp.broadcast_to(cam.center, target.shape)
    return material_labels(scene, origin, target - origin,
                           jnp.zeros(target.shape[0], jnp.float32))


def region_z_scores(a, b, labels, min_count: int = 1000) -> dict[str, float]:
    """{region: max over channels of |mean(a - b)| / SE} for the whole set
    ("all") and each material region with at least `min_count` samples.

    a, b: [n, 3] estimates of the same quantities (per-sample radiance of
    the same camera rays, or per-pixel means of two renders); labels: [n].
    SE_FLOOR keeps regions without randomness (sky seen directly) from
    dividing float rounding by float rounding."""
    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    labels = np.asarray(labels).reshape(-1)
    diff = a - b
    out = {}
    for name, sel in [("all", np.ones(labels.shape, bool))] + [
            (REGIONS[k], labels == k) for k in REGIONS]:
        n = int(sel.sum())
        if n < min_count:
            continue
        d = diff[sel]
        se = d.std(axis=0) / np.sqrt(n) + SE_FLOOR
        out[name] = float((np.abs(d.mean(axis=0)) / se).max())
    return out


def assert_statistically_equal(a, b, labels, z_max: float = Z_MAX,
                               min_count: int = 1000) -> dict[str, float]:
    """region_z_scores, raising AssertionError if any exceeds `z_max`."""
    z = region_z_scores(a, b, labels, min_count)
    bad = {k: v for k, v in z.items() if v > z_max}
    if bad:
        raise AssertionError(f"regions differ by more than {z_max} standard "
                             f"errors: {bad} (all z: {z})")
    return z


def rel_error(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def replay_rebuild_error(scene: Scene, origin, direction, time, seed,
                         max_depth: int, interpret: bool = False) -> float:
    """Relative error of replaying the megakernel's recorded residuals
    against the kernel's own radiance (must be below REPLAY_RTOL)."""
    from raytracingproject_tpu.grad.inverse import extract_params
    from raytracingproject_tpu.grad.replay import replay_radiance
    from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_record

    rad, res = pallas_trace_record(origin, direction, time, scene,
                                   jnp.int32(seed), max_depth,
                                   interpret=interpret)
    rebuilt = jax.jit(replay_radiance)(extract_params(scene), scene, origin,
                                       direction, time, res)
    return rel_error(rebuilt, rad)


def replay_grad_errors(scene: Scene, origin, direction, time, key,
                       max_depth: int) -> dict[str, float]:
    """{field: relative error} of replay gradients (residuals from
    replay.xla_trace_record) against jax.grad through render.ray_color with
    the same key. A random weighting of the radiance is the loss; rays whose
    replayed radiance differs from the recorded one by more than 2e-5 (an
    ulp-level closest-hit difference at a silhouette, amplified through
    frozen topology) carry no weight. Fields at exactly fuzz == 0 are the
    one documented estimator difference and are left out of `fuzz`."""
    from raytracingproject_tpu.grad.inverse import apply_params, extract_params
    from raytracingproject_tpu.grad.replay import replay_radiance, xla_trace_record
    from raytracingproject_tpu.render import ray_color

    params = extract_params(scene)
    rad, res = jax.jit(xla_trace_record, static_argnums=5)(
        scene, origin, direction, time, key, max_depth)
    rad_rp = jax.jit(replay_radiance)(params, scene, origin, direction, time, res)
    consistent = jnp.max(jnp.abs(rad - rad_rp), axis=-1) < 2e-5
    w = jax.random.uniform(jax.random.fold_in(key, 1), rad.shape)
    w = w * consistent[:, None]

    g_full = jax.jit(jax.grad(lambda p: jnp.sum(
        ray_color(apply_params(scene, p), origin, direction, time, key,
                  max_depth) * w)))(params)
    g_rp = jax.jit(jax.grad(lambda p: jnp.sum(
        replay_radiance(p, scene, origin, direction, time, res) * w)))(params)
    fuzz_ok = np.asarray(scene.fuzz) > 1e-6
    errs = {}
    for name in g_full._fields:
        a = np.asarray(getattr(g_full, name))
        b = np.asarray(getattr(g_rp, name))
        if name == "fuzz":
            a, b = a[fuzz_ok], b[fuzz_ok]
        errs[name] = rel_error(b, a)
    return errs
