"""Benchmark harness: prints ONE JSON line with the headline metric.

Metric: forward rays/sec of the GPU megakernel on the cover scene (~488
spheres, BASELINE config 3 geometry at 400x225, depth 16). "Rays" = camera
samples (pixels x spp); each ray additionally traverses up to max_depth
bounces, so the number is comparable across runs at fixed scene/depth.

Timing is device-true (tools/measure.py): a jitted scan of K passes reduced
to one scalar that is fetched to the host, timed at two K values, reporting
the marginal cost per pass over fresh salted keys. Requires a GPU; prints
the device and the card's name and power limit first.
"""

from __future__ import annotations

import json

from raytracingproject_tpu.utils.cache import enable_compilation_cache
from raytracingproject_tpu.utils.device import print_device_header

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.render import render_pass
from raytracingproject_tpu.scene import make_cover_scene
from tools.measure import marginal_seconds_per_pass

WIDTH, HEIGHT = 400, 225
MAX_DEPTH = 16
SPP_CHUNK = 4

METRIC = "fwd_rays_per_sec_cover400_d16_v2"


def main() -> None:
    device = print_device_header()
    enable_compilation_cache()
    scene = make_cover_scene(seed=0)
    camera = Camera(
        aspect_ratio=16.0 / 9.0,
        image_width=WIDTH,
        samples_per_pixel=SPP_CHUNK,
        max_depth=MAX_DEPTH,
        vfov=20.0,
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        defocus_angle=0.6,
        focus_dist=10.0,
    )
    cam = camera.derive()

    def one_pass(key):
        # raw_slots: slot-space radiance, as render() accumulates per chunk
        # (the [spp, H*W] unpermute happens once per frame)
        return render_pass(
            scene, cam, key, width=WIDTH, height=HEIGHT, max_depth=MAX_DEPTH,
            spp_chunk=SPP_CHUNK, use_megakernel=True, raw_slots=True,
        )

    sec_per_pass, checksum = marginal_seconds_per_pass(
        one_pass, k1=4, k2=12, reps=3
    )
    if not abs(checksum) < 1e30:
        raise RuntimeError(f"bad checksum {checksum}")
    rays = WIDTH * HEIGHT * SPP_CHUNK
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(rays / sec_per_pass, 1),
                "unit": "rays/s",
                "path": "megakernel",
                "device": device,
                "methodology": "scan-marginal host-fetch (tools/measure.py)",
            }
        )
    )


if __name__ == "__main__":
    main()
