"""Time the Triton megakernel against the XLA path on the GPU.

    python tools/bench_megakernel.py [--width 400] [--spp 4] [--depth 50]

Cover scene (488 spheres). For each kernel variant (rays per program BLOCK,
spheres per loop iteration UNROLL) and for the XLA renderer
(render.ray_color with early exit) on the same camera rays: compile time,
then seconds per pass (median of --reps, each ending in
block_until_ready) and camera rays per second. Also compares the images'
channel means, so a variant that computes garbage fast is caught.
Requires a GPU.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracingproject_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from raytracingproject_tpu.utils.device import print_device_header  # noqa: E402


def timed(fn, reps):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(0))
    compile_s = time.perf_counter() - t0
    ts = []
    for r in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r + 1))
        ts.append(time.perf_counter() - t0)
    return compile_s, statistics.median(ts), ts, np.asarray(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default="32x8,64x8,128x8,256x8,32x4,32x16",
                    help="comma list of BLOCKxUNROLL")
    args = ap.parse_args(argv)

    print_device_header()
    enable_compilation_cache()

    from raytracingproject_tpu.camera import Camera, generate_rays
    from raytracingproject_tpu.ops.pallas import megakernel as mk
    from raytracingproject_tpu.render import _block_order, ray_color
    from raytracingproject_tpu.scene import make_cover_scene

    scene = make_cover_scene(seed=0)
    camera = Camera(
        aspect_ratio=16.0 / 9.0, image_width=args.width,
        samples_per_pixel=args.spp, max_depth=args.depth, vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6, focus_dist=10.0,
    )
    w, h = camera.image_size()
    cam = camera.derive()
    slot_pix, _ = _block_order(w, h, args.spp, mk.BLOCK)
    i = jnp.asarray(slot_pix % w)
    j = jnp.asarray(slot_pix // w)
    o, d, t = jax.jit(generate_rays)(cam, i, j, jax.random.PRNGKey(0))
    rays = int(o.shape[0])
    print(f"cover scene, {w}x{h}, {args.spp} spp, depth {args.depth}: "
          f"{rays} camera rays", flush=True)

    rows = []
    for v in args.variants.split(","):
        block, unroll = (int(x) for x in v.split("x"))
        mk.UNROLL = unroll
        jax.clear_caches()
        fn = jax.jit(lambda o, d, t, s, b=block: mk.pallas_trace_paths(
            o, d, t, scene, s, args.depth, block=b))
        c, med, ts, img = timed(lambda r: fn(o, d, t, jnp.int32(r)), args.reps)
        rows.append((f"kernel B={block} U={unroll}", c, med, ts, img))
    mk.UNROLL = 8
    jax.clear_caches()

    xla = jax.jit(lambda o, d, t, k: ray_color(scene, o, d, t, k, args.depth,
                                               early_exit=True))
    c, med, ts, img = timed(lambda r: xla(o, d, t, jax.random.PRNGKey(r)),
                            args.reps)
    rows.append(("xla ray_color early_exit", c, med, ts, img))

    # XLA's closest hit alone, at one config-3 pass (1200x675 rays): its
    # time, whether [R, N] intermediates reach device memory (temp bytes),
    # and whether the "rnc,rc->rn" contraction became a library matmul.
    from raytracingproject_tpu.ops.intersect import closest_hit

    n_hit = 1200 * 675
    oh, dh, th = (jnp.resize(x, (n_hit,) + x.shape[1:]) for x in (o, d, t))
    ch = jax.jit(lambda o, d, t: closest_hit(
        o, d, t, scene.center0, scene.center_delta, scene.radius).t)
    compiled = ch.lower(oh, dh, th).compile()
    mem = compiled.memory_analysis()
    hlo = compiled.as_text()
    c, med, ts, _ = timed(lambda r: ch(oh, dh, th), args.reps)
    rn_bytes = n_hit * int(scene.radius.shape[0]) * 4
    print(f"xla closest_hit, {n_hit} rays x {scene.radius.shape[0]} spheres: "
          f"{med * 1e3:.3f} ms (runs ms: {', '.join(f'{x * 1e3:.3f}' for x in ts)}); "
          f"temp bytes {mem.temp_size_in_bytes} (one [R, N] f32 array is "
          f"{rn_bytes}); fusions {hlo.count(' fusion(')}, library calls "
          f"{[ln.strip()[:160] for ln in hlo.splitlines() if 'custom-call' in ln]}, "
          f"dots {[ln.strip()[:160] for ln in hlo.splitlines() if ' dot(' in ln]}",
          flush=True)

    ref_mean = rows[-1][4].mean(axis=0)
    for name, c, med, ts, img in rows:
        print(f"{name}: compile+first {c:.2f} s, {med * 1e3:.3f} ms/pass, "
              f"{rays / med / 1e6:.3f} Mrays/s (runs ms: "
              f"{', '.join(f'{x * 1e3:.3f}' for x in ts)}), channel means "
              f"{np.round(img.mean(axis=0), 4).tolist()} "
              f"(xla {np.round(ref_mean, 4).tolist()})", flush=True)
        if not np.isfinite(img).all():
            raise RuntimeError(f"{name}: non-finite radiance")
    return 0


if __name__ == "__main__":
    sys.exit(main())
