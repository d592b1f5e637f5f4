"""BASELINE config 3 end-to-end: cover scene (~488 spheres), 1200x675,
128 spp, depth 50, on the GPU megakernel.

The closest analog of the reference's flagship render (src/main.cpp:55-68:
400x225, 30 spp, depth 50) scaled to the BASELINE resolution/spp. Runs the
megakernel in spp chunks and reports

  1. device-true rays/s for the chunk pass (tools/measure.py marginal
     methodology), and
  2. the end-to-end wall time of the full frame, barriered by fetching the
     final u8 image to the host (a true data dependency),

then writes the frame (P6 PPM) and a JSON record under bench_out/.
Requires a GPU; prints the device and the card's name and power limit.

    python tools/bench_config3.py [--spp N] [--depth D]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytracingproject_tpu.camera import Camera  # noqa: E402
from raytracingproject_tpu.color import to_u8  # noqa: E402
from raytracingproject_tpu.ops.pallas.megakernel import BLOCK  # noqa: E402
from raytracingproject_tpu.render import blocks_to_image, render_pass  # noqa: E402
from raytracingproject_tpu.scene import make_cover_scene  # noqa: E402
from raytracingproject_tpu.utils.cache import enable_compilation_cache  # noqa: E402
from raytracingproject_tpu.utils.device import print_device_header  # noqa: E402
from tools.artifact import artifact_path  # noqa: E402
from tools.measure import fresh_salt, marginal_seconds_per_pass  # noqa: E402

WIDTH, HEIGHT = 1200, 675
SPP_CHUNK = 4


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--depth", type=int, default=50)
    args = ap.parse_args()
    if args.spp % SPP_CHUNK:
        raise SystemExit(f"--spp must be a multiple of {SPP_CHUNK}")
    device = print_device_header()
    enable_compilation_cache()

    scene = make_cover_scene(seed=0)
    camera = Camera(
        aspect_ratio=16.0 / 9.0, image_width=WIDTH, samples_per_pixel=args.spp,
        max_depth=args.depth, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )
    cam = camera.derive()

    def one_pass(key):
        # slot-space accumulation: the unpermute happens once per frame
        return render_pass(
            scene, cam, key, width=WIDTH, height=HEIGHT, max_depth=args.depth,
            spp_chunk=SPP_CHUNK, use_megakernel=True, raw_slots=True,
        )

    # 1. device-true chunk-pass throughput
    sec_per_pass, checksum = marginal_seconds_per_pass(one_pass, k1=1, k2=3, reps=3)
    if not np.isfinite(checksum):
        raise RuntimeError(f"bad checksum {checksum}")
    rays_per_sec = WIDTH * HEIGHT * SPP_CHUNK / sec_per_pass

    # 2. end-to-end frame: scan over all chunks inside one jit, barriered by
    # fetching the u8 image itself
    n_chunks = args.spp // SPP_CHUNK
    r_pad = -(-WIDTH * HEIGHT * SPP_CHUNK // BLOCK) * BLOCK

    @jax.jit
    def full_frame(key):
        def body(acc, c):
            return acc + one_pass(jax.random.fold_in(key, c)), None

        acc, _ = jax.lax.scan(body, jnp.zeros((r_pad, 3), jnp.float32),
                              jnp.arange(n_chunks))
        return to_u8(blocks_to_image(acc, WIDTH, HEIGHT, SPP_CHUNK) / args.spp)

    img = np.asarray(full_frame(jax.random.PRNGKey(fresh_salt())))  # compile
    t0 = time.perf_counter()
    img = np.asarray(full_frame(jax.random.PRNGKey(fresh_salt())))
    frame_s = time.perf_counter() - t0

    path = artifact_path("CONFIG3")
    out_ppm = path.replace(".json", f"_{args.spp}spp.ppm")
    with open(out_ppm, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (WIDTH, HEIGHT))
        f.write(img.tobytes())

    out = {
        "config": "baseline_3_cover_1200x675",
        "spp": args.spp,
        "max_depth": args.depth,
        "n_spheres": int(scene.radius.shape[0]),
        "path": "megakernel",
        "rays_per_sec_marginal": round(rays_per_sec, 1),
        "frame_seconds_end_to_end": round(frame_s, 2),
        "rays_per_sec_end_to_end": round(WIDTH * HEIGHT * args.spp / frame_s, 1),
        "image_mean_u8": round(float(img.mean()), 2),
        "device": device,
        "ppm": out_ppm,
    }
    print(json.dumps(out), flush=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
