"""Scaling-efficiency harness: rays/s vs mesh size, on the GPUs JAX finds.

Renders the same total work on 1, 2, 4, ... device meshes (`rays` axis) and
reports parallel efficiency — the BASELINE.md target is >=80% from 1 host
to 4 hosts. Requires a GPU (prints the device and the cards' name and
power limit first); on one card it measures the single-device shard_map
overhead only.

    python bench_scaling.py

Prints one JSON line: {"devices": [...], "rays_per_sec": [...],
"efficiency": [...], ...}.
"""

from __future__ import annotations

import json
import time

import jax

import numpy as np

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.parallel import make_mesh, render_sharded
from raytracingproject_tpu.scene import make_three_sphere_scene
from raytracingproject_tpu.utils.device import print_device_header

WIDTH, SPP, DEPTH = 256, 8, 8


def _camera() -> Camera:
    return Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=WIDTH,
        samples_per_pixel=SPP,
        max_depth=DEPTH,
        vfov=90.0,
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
    )


def measure(n_devices: int) -> float:
    """Forward rays/s on an n-device mesh. Exercises BOTH mesh axes when
    n is even (rays x samples) — the samples-axis psum is the collective
    the pod-scale config rides."""
    samples_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(
        devices=jax.devices()[:n_devices], samples_axis_size=samples_axis
    )
    scene = make_three_sphere_scene()
    cam = _camera()
    rays = WIDTH * cam.image_height * SPP

    # warmup/compile
    np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(0), mesh))
    t0 = time.perf_counter()
    reps = 3
    for i in range(reps):
        np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(i + 1), mesh))
    dt = (time.perf_counter() - t0) / reps
    return rays / dt


def measure_train(n_devices: int) -> float:
    """fwd+bwd rays/s through the sharded inverse-rendering step (pixel
    loss + psum-ed grads + Adam)."""
    from raytracingproject_tpu.grad.inverse import extract_params
    from raytracingproject_tpu.parallel import make_sharded_train_step

    samples_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(
        devices=jax.devices()[:n_devices], samples_axis_size=samples_axis
    )
    scene = make_three_sphere_scene()
    cam = _camera()
    spp = 4
    rays = WIDTH * cam.image_height * spp
    target = render_sharded(scene, cam, jax.random.PRNGKey(0), mesh, spp=spp)
    params, opt_state, step = make_sharded_train_step(
        scene, cam, mesh, spp=spp, trainable=("albedo", "center0")
    )
    params, opt_state, loss, _ = step(params, opt_state, jax.random.PRNGKey(1), target)
    float(loss)  # compile + barrier
    t0 = time.perf_counter()
    reps = 3
    for i in range(reps):
        params, opt_state, loss, _ = step(
            params, opt_state, jax.random.fold_in(jax.random.PRNGKey(2), i), target
        )
    float(loss)
    dt = (time.perf_counter() - t0) / reps
    return rays / dt


def measure_single_device() -> dict:
    """Single-device shard_map overhead: the megakernel path through the
    identical flat feed (parallel.shard._render_flat) called directly under
    jit vs wrapped in shard_map over a 1x1 mesh (render_sharded). The
    render_pass feed is measured too, with the once-per-frame unpermute
    (end-to-end) and in slot space (the marginal path). Cover scene, depth
    16, 5 reps with median and spread per row; an overhead smaller than the
    measured spread is reported as below the noise floor."""
    import functools

    from raytracingproject_tpu.parallel.shard import _render_flat, _pixel_grid
    from raytracingproject_tpu.render import render_pass
    from raytracingproject_tpu.scene import make_cover_scene
    from tools.measure import marginal_seconds_per_pass

    cw, cdepth, cspp = 400, 16, 4
    cam = Camera(
        aspect_ratio=16.0 / 9.0, image_width=cw, samples_per_pixel=cspp,
        max_depth=cdepth, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )
    scene = make_cover_scene(seed=0)
    camd = cam.derive()
    height = cam.image_height
    rays = cw * height * cspp
    mesh = make_mesh(devices=jax.devices()[:1], samples_axis_size=1)
    i, j = _pixel_grid(cw, height, 1)

    @functools.partial(jax.jit)
    def flat_unsharded(key):
        return _render_flat(
            scene, camd, i, j, key, max_depth=cdepth, spp_local=cspp,
            use_megakernel=True,
        )

    def sharded(key):
        return render_sharded(scene, cam, key, mesh, use_megakernel=True)

    def production_frame(key):
        return render_pass(
            scene, camd, key, width=cw, height=height, max_depth=cdepth,
            spp_chunk=cspp, use_megakernel=True,
        )

    def production_slots(key):
        return render_pass(
            scene, camd, key, width=cw, height=height, max_depth=cdepth,
            spp_chunk=cspp, use_megakernel=True, raw_slots=True,
        )

    out = {"single_device_scene": "cover488",
           "single_device_config": f"{cw}px_d{cdepth}_spp{cspp}", "reps": 5}
    meds = {}
    spreads = {}
    for name, fn in (
        ("flat", flat_unsharded), ("mesh1x1", sharded),
        ("render_pass_frame", production_frame),
        ("render_pass_slots", production_slots),
    ):
        med, _, all_m = marginal_seconds_per_pass(
            fn, k1=2, k2=6, reps=5, return_all=True
        )
        meds[name] = med
        spreads[name] = (all_m[-1] - all_m[0]) / med if med else 0.0
        out[f"single_device_{name}_rays_per_sec"] = round(rays / med, 1)
        out[f"single_device_{name}_spread_frac"] = round(spreads[name], 3)

    def overhead(a, b):
        """Relative cost of b over a, floored at the joint noise floor."""
        noise = max(spreads[a], spreads[b])
        val = meds[b] / meds[a] - 1.0
        if val <= noise:
            return f"<= noise floor ({noise:.1%})"
        return round(val, 3)

    out["single_device_shard_map_overhead"] = overhead("flat", "mesh1x1")
    out["single_device_unpermute_overhead"] = overhead(
        "render_pass_slots", "render_pass_frame"
    )
    return out


def main() -> None:
    print_device_header()
    avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= avail]
    rates = [measure(n) for n in sizes]
    train_rates = [measure_train(n) for n in sizes]
    base = rates[0]
    eff = [r / (base * n) for r, n in zip(rates, sizes)]
    out = {
        "devices": sizes,
        "rays_per_sec": [round(r, 1) for r in rates],
        "train_rays_per_sec": [round(r, 1) for r in train_rates],
        "efficiency": [round(e, 3) for e in eff],
        "backend": jax.default_backend(),
    }
    out.update(measure_single_device())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
