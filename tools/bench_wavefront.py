"""Prove-or-retire benchmark for the wavefront renderer.

Its pitch (wavefront.py:1-21) is "per-bounce compute scales with LIVE rays"
— which should pay off on high-depth, low-coherence workloads where the
lockstep megakernel drags dead lanes through the remaining bounces. This
measures all forward paths on exactly that workload (cover scene, deep
bounces, dielectric-heavy view) plus the standard bench config, device-true
(tools/measure.py), and writes a JSON record under bench_out/. Requires a
GPU; prints the device and the card's name and power limit.

    python -m tools.bench_wavefront
"""

from __future__ import annotations

import json

from raytracingproject_tpu.utils.cache import enable_compilation_cache
from raytracingproject_tpu.utils.device import print_device_header

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.render import render_pass
from raytracingproject_tpu.scene import make_cover_scene
from raytracingproject_tpu.wavefront import render_wavefront
from tools.measure import marginal_seconds_per_pass

CONFIGS = [
    # (label, width, spp, depth): depth-16 standard vs depth-50 (the
    # reference's own max_depth, src/main.cpp:59) where early termination
    # matters most.
    ("cover_400px_spp4_d16", 400, 4, 16),
    ("cover_200px_spp8_d50", 200, 8, 50),
]


def main() -> None:
    device = print_device_header()
    enable_compilation_cache()
    scene = make_cover_scene(seed=0)
    results = {"device": device}
    for label, width, spp, depth in CONFIGS:
        cam = Camera(
            aspect_ratio=16 / 9, image_width=width, samples_per_pixel=spp,
            max_depth=depth, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
            lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
        )
        height = cam.image_height
        rays = width * height * spp

        def pass_mega(key):
            return render_pass(scene, cam.derive(), key, width=width,
                               height=height, max_depth=depth, spp_chunk=spp,
                               use_megakernel=True)

        def pass_early(key):
            return render_pass(scene, cam.derive(), key, width=width,
                               height=height, max_depth=depth, spp_chunk=spp,
                               early_exit=True)

        def pass_wave(key):
            return render_wavefront(scene, cam.derive(), key, width=width,
                                    height=height, spp=spp, max_depth=depth,
                                    pool_size=1 << 16)

        paths = {"xla_early_exit": pass_early, "wavefront": pass_wave,
                 "megakernel": pass_mega}
        entry = {}
        for name, fn in paths.items():
            sec, _ = marginal_seconds_per_pass(fn, k1=2, k2=6, reps=3)
            entry[name] = round(rays / sec, 1)
            print(json.dumps({"metric": f"{label}_{name}", "value": entry[name],
                              "unit": "rays/s"}), flush=True)
        results[label] = entry

    from tools.artifact import artifact_path

    with open(artifact_path("WAVEFRONT"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
