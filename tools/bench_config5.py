"""BASELINE config 5, single-card slice: 4K (3840x2160) at 512 spp.

The pod-scale config's mesh sharding is exercised by
`chip_smoke.py --four-cards` and the 8-device dryrun
(__graft_entry__.dryrun_multichip); what a single card can prove is the
chunking/memory path at 4K — ~4.25 G camera samples per frame streamed
through the megakernel in spp chunks without running out of memory — and
the frame time at that scale. The record carries the device's reported
peak memory and the analytic per-pass footprint (every live [R]-sized plane
of the megakernel pass, itemized below). A short 16-spp probe frame is timed
at spp_chunk 1/2/4; the full frame then runs at the best chunk. Requires a
GPU; prints the device and the card's name and power limit.

Run: python -m tools.bench_config5 [--spp 512] [--sweep-spp 16]
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

from raytracingproject_tpu.utils.cache import enable_compilation_cache
from raytracingproject_tpu.utils.device import print_device_header

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.color import to_u8
from raytracingproject_tpu.config import RenderSettings
from raytracingproject_tpu.render import render
from raytracingproject_tpu.scene import make_cover_scene
from tools.measure import fresh_salt

WIDTH, HEIGHT = 3840, 2160


def analytic_pass_bytes(spp_chunk: int) -> dict:
    """Itemized device footprint of one megakernel render pass at 4K.

    Counts every [R]-scaled buffer live during a pass (f32 unless noted):
    7 input ray planes (o, d, t), 3 radiance outputs, ~13 ray-generation
    intermediates (pixel jitter, defocus samples, direction assembly —
    XLA fuses most into the feed, bounded above), the persistent slot-space
    accumulator [R_pad, 3], and the per-frame unpermute gather indices
    [spp_chunk, H*W] i32. The sphere table is KBs and ignored."""
    from raytracingproject_tpu.ops.pallas.megakernel import BLOCK

    pixels = WIDTH * HEIGHT
    r = pixels * spp_chunk
    r_pad = -(-r // BLOCK) * BLOCK
    items = {
        "ray_planes_in": 7 * r_pad * 4,
        "radiance_out": 3 * r_pad * 4,
        "raygen_intermediates_bound": 13 * r * 4,
        "slot_accumulator": r_pad * 3 * 4,
        "unpermute_gather_idx": spp_chunk * pixels * 4,
    }
    items["total"] = sum(items.values())
    return items


def frame(scene, settings, spp: int, depth: int, key) -> tuple[float, np.ndarray]:
    camera = Camera(
        aspect_ratio=16.0 / 9.0, image_width=WIDTH, samples_per_pixel=spp,
        max_depth=depth, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )
    t0 = time.perf_counter()
    img = render(scene, camera, key, settings)
    u8 = np.asarray(to_u8(img))  # host fetch = true frame barrier
    return time.perf_counter() - t0, u8


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=512)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--sweep-spp", type=int, default=16)
    ap.add_argument("--chunks", type=int, nargs="*", default=[1, 2, 4])
    args = ap.parse_args()
    device = print_device_header()
    enable_compilation_cache()

    scene = make_cover_scene(seed=0)
    pixels = WIDTH * HEIGHT

    def settings_for(chunk: int) -> RenderSettings:
        return RenderSettings(
            use_megakernel=True, rays_per_batch=pixels * chunk, sync_every=8,
        )

    # ---- spp_chunk sweep on a short frame ----
    sweep = {}
    for chunk in args.chunks:
        st = settings_for(chunk)
        # warm/compile at this chunk shape
        frame(scene, st, chunk, args.depth, jax.random.PRNGKey(0))
        sec, _ = frame(scene, st, args.sweep_spp, args.depth,
                       jax.random.PRNGKey(fresh_salt()))
        sweep[chunk] = round(sec, 2)
        print(json.dumps({"spp_chunk": chunk, "sweep_spp": args.sweep_spp,
                          "seconds": sweep[chunk]}), flush=True)
    best_chunk = min(sweep, key=sweep.get)

    # ---- full frame at the best chunk ----
    st = settings_for(best_chunk)
    frame_s, u8 = frame(scene, st, args.spp, args.depth,
                        jax.random.PRNGKey(fresh_salt()))
    total_rays = pixels * args.spp

    stats = jax.local_devices()[0].memory_stats() or {}
    out = {
        "config": "baseline_5_single_card_slice_4k",
        "resolution": f"{WIDTH}x{HEIGHT}",
        "spp": args.spp,
        "max_depth": args.depth,
        "total_rays": total_rays,
        "spp_chunk": best_chunk,
        "spp_chunk_sweep_seconds": {str(k): v for k, v in sweep.items()},
        "sweep_spp": args.sweep_spp,
        "n_chunks": (args.spp + best_chunk - 1) // best_chunk,
        "frame_seconds": round(frame_s, 1),
        "rays_per_sec": round(total_rays / frame_s, 1),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "analytic_pass_bytes": analytic_pass_bytes(best_chunk),
        "image_mean_u8": round(float(u8.mean()), 2),
        "device": device,
    }
    print(json.dumps(out), flush=True)

    from tools.artifact import artifact_path

    with open(artifact_path("CONFIG5"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
