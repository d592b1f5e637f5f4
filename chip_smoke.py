"""Smoke test of the path tracer on one GPU: the quickest proof that the
system still starts on the card and computes the right thing.

    python chip_smoke.py                # phases 1-4, one GPU
    python chip_smoke.py --four-cards   # phase 5 only, four GPUs

Phases (one process; every kernel compiled for the card, none interpreted):

1. CLI forward at the reference operating point: the cover scene (488
   spheres), 400x225, 30 spp, depth 50, through `__main__.main` into a PPM.
2. render() at BASELINE config 3 (1200x675, 128 spp, depth 50) with the
   megakernel and with the plain XLA path, compared statistically per
   material region (validation.py); the megakernel with an injected
   Schlick-exponent bug must fail the same test. Times both paths.
3. Fast train steps (megakernel forward + path-replay backward) at 400x225,
   depth 8 and 50, training albedo, centres and radii: finite losses and
   gradients, the replay rebuilding the kernel's radiance, and replay
   gradients matching reverse mode through render.ray_color.
4. RendererSession at its default 1024x768, 3 frames.
5. (--four-cards) render_sharded with the megakernel on (rays=4, samples=1)
   and (rays=2, samples=2) meshes against a single-card render, sharded
   train steps, and per-device memory use.

Exits non-zero, without the final JSON line, when JAX finds no GPU or any
phase fails. The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def timer(label: str):
    t0 = time.perf_counter()
    yield
    log(f"  {label}: {time.perf_counter() - t0:.3f} s")


def cover_camera(width: int, spp: int, depth: int):
    from raytracingproject_tpu.camera import Camera

    return Camera(
        aspect_ratio=16.0 / 9.0, image_width=width, samples_per_pixel=spp,
        max_depth=depth, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
    )


def frame_rays(camera, key):
    """Camera rays of every pixel, spp samples each (sample-major)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingproject_tpu.camera import generate_rays

    w, h = camera.image_size()
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    spp = camera.samples_per_pixel
    i = jnp.asarray(np.tile(ii.reshape(-1), spp), jnp.int32)
    j = jnp.asarray(np.tile(jj.reshape(-1), spp), jnp.int32)
    return jax.jit(generate_rays)(camera.derive(), i, j, key)


def chunked(fn, arrays, chunk: int = 1 << 18):
    """fn over ray chunks, concatenated (bounds the XLA path's [R, N])."""
    import jax.numpy as jnp

    n = arrays[0].shape[0]
    return jnp.concatenate([fn(*(a[s:s + chunk] for a in arrays))
                            for s in range(0, n, chunk)])


def phase_cli():
    import numpy as np

    from raytracingproject_tpu.__main__ import main as cli_main
    from raytracingproject_tpu.utils.ppm import read_ppm

    log("phase 1: CLI, cover scene 400x225, 30 spp, depth 50")
    with tempfile.TemporaryDirectory() as td:
        out = Path(td) / "image.ppm"
        with timer("CLI run (compile included)"):
            rc = cli_main(["--output", str(out)])
        if rc != 0:
            raise RuntimeError(f"CLI returned {rc}")
        img = read_ppm(out)
    if img.shape != (225, 400, 3):
        raise RuntimeError(f"PPM has shape {img.shape}, expected (225, 400, 3)")
    if img.std() < 5.0:
        raise RuntimeError(f"image is (nearly) constant: std {img.std():.3f}")
    log(f"  PPM {img.shape}, mean {img.mean():.2f}, std {img.std():.2f}")


def phase_render(W=1200, SPP=128, DEPTH=50):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingproject_tpu.config import RenderSettings
    from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_paths
    from raytracingproject_tpu.render import ray_color, render
    from raytracingproject_tpu.scene import make_cover_scene
    from raytracingproject_tpu.validation import (
        Z_MAX, assert_statistically_equal, material_labels,
        pixel_material_labels, region_z_scores,
    )

    scene = make_cover_scene(seed=0)
    camera = cover_camera(W, SPP, DEPTH)
    w, h = camera.image_size()
    rays = w * h * SPP
    log(f"phase 2: render() config 3, cover scene {w}x{h}, {SPP} spp, "
        f"depth {DEPTH} ({rays} camera rays per frame)")
    images = {}
    for name, settings in (("megakernel", RenderSettings(use_megakernel=True)),
                           ("xla", RenderSettings())):
        key = jax.random.PRNGKey(1 if name == "xla" else 2)
        t0 = time.perf_counter()
        jax.block_until_ready(render(scene, camera, key, settings))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        img = jax.block_until_ready(render(scene, camera, key, settings))
        sec = time.perf_counter() - t0
        images[name] = np.asarray(img)
        log(f"  {name}: first frame (compile included) {first:.3f} s; "
            f"steady frame {sec:.3f} s = {rays / sec / 1e6:.3f} Mrays/s")
        if not np.isfinite(images[name]).all():
            raise RuntimeError(f"{name}: non-finite image")
    labels = pixel_material_labels(scene, camera)
    z = assert_statistically_equal(images["megakernel"].reshape(-1, 3),
                                   images["xla"].reshape(-1, 3), labels)
    log(f"  megakernel vs xla, per-pixel z-scores (max {Z_MAX}): {z}")

    # The same test must fail an injected physics bug. Per camera sample,
    # 2 spp of the frame, against ray_color on the same rays.
    o, d, t = frame_rays(cover_camera(W, 2, DEPTH), jax.random.PRNGKey(3))
    lab = material_labels(scene, o, d, t)
    ref = chunked(jax.jit(lambda o, d, t: ray_color(
        scene, o, d, t, jax.random.PRNGKey(4), DEPTH, early_exit=True)),
        (o, d, t))
    ok = pallas_trace_paths(o, d, t, scene, jnp.int32(5), DEPTH)
    bug = pallas_trace_paths(o, d, t, scene, jnp.int32(5), DEPTH,
                             inject_bug="schlick3")
    z_ok = assert_statistically_equal(ok, ref, lab)
    z_bug = region_z_scores(bug, ref, lab)
    log(f"  per-sample z, megakernel: {z_ok}")
    log(f"  per-sample z, megakernel with schlick^3 bug: {z_bug}")
    if z_bug.get("dielectric", 0.0) <= Z_MAX:
        raise RuntimeError("the statistical test did not detect the injected "
                           f"schlick^3 bug: {z_bug}")


@contextmanager
def xla_residuals():
    """Within the block, grad/fast.py records its residuals with
    replay.xla_trace_record instead of the megakernel: the plain
    alternative the kernel is timed against."""
    import jax

    from raytracingproject_tpu.grad.replay import xla_trace_record
    from raytracingproject_tpu.ops.pallas import megakernel
    from raytracingproject_tpu.render import ray_color

    def key_of(seed):
        return jax.random.PRNGKey(seed.astype("uint32"))

    def paths(o, d, t, s, seed, max_depth, interpret=False):
        return ray_color(s, o, d, t, key_of(seed), max_depth)

    def record(o, d, t, s, seed, max_depth, interpret=False):
        return xla_trace_record(s, o, d, t, key_of(seed), max_depth)

    with mock.patch.object(megakernel, "pallas_trace_paths", paths), \
            mock.patch.object(megakernel, "pallas_trace_record", record):
        yield


def phase_train(W=400, SPP=8, depths=(8, 50)):
    import jax
    import numpy as np

    from raytracingproject_tpu.grad.fast import make_fast_train_step
    from raytracingproject_tpu.render import render
    from raytracingproject_tpu.scene import make_cover_scene
    from raytracingproject_tpu.validation import (
        GRAD_RTOL, REPLAY_RTOL, replay_grad_errors, replay_rebuild_error,
    )

    scene = make_cover_scene(seed=0)
    # perturb materials, and the three large spheres' geometry
    wrong = scene._replace(albedo=scene.albedo * 0.8,
                           center0=scene.center0.at[-3:].add(0.05),
                           radius=scene.radius.at[-3:].multiply(1.02))
    trainable = ("albedo", "center0", "radius")
    for depth in depths:
        camera = cover_camera(W, SPP, depth)
        w, h = camera.image_size()
        log(f"phase 3: fast train steps, cover scene {w}x{h}, {SPP} spp, "
            f"depth {depth}")
        target = render(scene, cover_camera(W, 4, depth),
                        jax.random.PRNGKey(0))
        for name in ("megakernel", "xla residuals"):
            if name == "megakernel":
                p, s, step = make_fast_train_step(
                    wrong, camera, spp=SPP, trainable=trainable)
            else:
                with xla_residuals():
                    p, s, step = make_fast_train_step(
                        wrong, camera, spp=SPP, trainable=trainable)
            times, losses = [], []
            for it in range(3):
                t0 = time.perf_counter()
                p, s, loss, grads = step(p, s, jax.random.PRNGKey(10 + it),
                                         target)
                jax.block_until_ready(grads)
                times.append(time.perf_counter() - t0)
                losses.append(float(loss))
                if not np.isfinite(float(loss)):
                    raise RuntimeError(f"{name}: non-finite loss {loss}")
                for f, g in grads._asdict().items():
                    if not np.isfinite(np.asarray(g)).all():
                        raise RuntimeError(f"{name}: non-finite {f} gradient")
            log(f"  {name}: losses {losses}; step 1 (compile included) "
                f"{times[0]:.3f} s, steps 2-3 {times[1]:.3f} s, "
                f"{times[2]:.3f} s = {w * h * SPP / times[2] / 1e6:.3f} "
                "Mrays/s forward+backward")

        o, d, t = frame_rays(cover_camera(W, 1, depth), jax.random.PRNGKey(5))
        err = replay_rebuild_error(scene, o, d, t, 6, depth)
        log(f"  replay rebuilds the megakernel radiance of {o.shape[0]} rays:"
            f" relative error {err:.3e} (bound {REPLAY_RTOL})")
        if not err < REPLAY_RTOL:
            raise RuntimeError("replay does not rebuild the kernel's radiance")
        sub = slice(0, None, 22)  # 4091 rays spread over the frame
        errs = replay_grad_errors(scene, o[sub], d[sub], t[sub],
                                  jax.random.PRNGKey(7), depth)
        log(f"  replay vs reverse-mode gradients, {o[sub].shape[0]} rays: "
            f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (bound {GRAD_RTOL})")
        bad = {k: v for k, v in errs.items() if not v < GRAD_RTOL}
        if bad:
            raise RuntimeError(f"replay gradients differ: {bad}")


def phase_session():
    import numpy as np

    from raytracingproject_tpu.session import RendererSession

    log("phase 4: RendererSession, default 1024x768, 3 frames")
    s = RendererSession()
    s.init()
    s.load_preconfigured_shapes()
    with timer("3 frames (compile included)"):
        frames = s.start_interactive_loop(duration_ms=600_000, max_frames=3)
    img = s.last_frame
    if frames != 3 or img is None or img.shape != (768, 1024, 3):
        raise RuntimeError(f"session rendered {frames} frames, last "
                           f"{None if img is None else img.shape}")
    if not np.isfinite(img).all() or np.asarray(img).std() < 1e-2:
        raise RuntimeError("session frame is non-finite or constant")
    log(f"  frame {img.shape}, mean {img.mean():.4f}, std {img.std():.4f}")


def phase_four_cards(width=3840, spp=8, depth=50, train_width=400,
                     interpret=False):
    """render_sharded and the sharded train steps over four devices. The
    keyword arguments let a rehearsal on virtual CPU devices run it small,
    through Pallas's interpreter."""
    import jax
    import numpy as np

    from raytracingproject_tpu.config import RenderSettings
    from raytracingproject_tpu.parallel import (
        make_mesh, make_sharded_train_step, render_sharded,
    )
    from raytracingproject_tpu.parallel.shard import make_sharded_soft_train_step
    from raytracingproject_tpu.render import render
    from raytracingproject_tpu.scene import make_cover_scene
    from raytracingproject_tpu.validation import (
        Z_MAX, assert_statistically_equal, pixel_material_labels,
    )

    devs = jax.devices()
    if len(devs) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    scene = make_cover_scene(seed=0)
    camera = cover_camera(width, spp, depth)
    w, h = camera.image_size()
    log(f"phase 5: render_sharded with the megakernel, {w}x{h}, {spp} spp "
        f"(cut from 128 to fit the run), depth {depth}")
    # The reference is the single-card megakernel (phase 2 compares it with
    # the XLA path): at 8.3M rays per pass the XLA path's [rays, spheres]
    # intersection arrays would not fit one card.
    t0 = time.perf_counter()
    ref = np.asarray(render(scene, camera, jax.random.PRNGKey(0),
                            RenderSettings(use_megakernel=True)))
    log(f"  single-card megakernel render (compile included): "
        f"{time.perf_counter() - t0:.3f} s")
    labels = pixel_material_labels(scene, camera)
    for samples in (1, 2):
        mesh = make_mesh(samples_axis_size=samples)
        for run in ("first (compile included)", "steady"):
            t0 = time.perf_counter()
            img = jax.block_until_ready(render_sharded(
                scene, camera, jax.random.PRNGKey(samples), mesh,
                use_megakernel=True, interpret=interpret))
            log(f"  mesh rays={4 // samples} samples={samples}, {run}: "
                f"{time.perf_counter() - t0:.3f} s")
        z = assert_statistically_equal(np.asarray(img).reshape(-1, 3),
                                       ref.reshape(-1, 3), labels)
        log(f"  vs single-card render, z-scores (max {Z_MAX}): {z}")

    tcam = cover_camera(train_width, 4, 8)
    target = render(scene, tcam, jax.random.PRNGKey(1))
    wrong = scene._replace(albedo=scene.albedo * 0.8)
    mesh = make_mesh(samples_axis_size=2)
    p, s, step = make_sharded_train_step(
        wrong, tcam, mesh, spp=4, trainable=("albedo", "center0", "radius"),
        use_megakernel=True, interpret=interpret)
    for it in range(3):
        t0 = time.perf_counter()
        p, s, loss, grads = step(p, s, jax.random.PRNGKey(20 + it), target)
        jax.block_until_ready(grads)
        ok = np.isfinite(float(loss)) and all(
            np.isfinite(np.asarray(g)).all() for g in grads)
        log(f"  sharded fast train step {it + 1}: loss {float(loss):.6f}, "
            f"{time.perf_counter() - t0:.3f} s")
        if not ok:
            raise RuntimeError("non-finite sharded loss or gradients")
    p, s, step = make_sharded_soft_train_step(
        wrong, tcam, mesh, spp=2, trainable=("center0", "radius"),
        candidates_k=4)
    p, s, loss, grads = step(p, s, jax.random.PRNGKey(30), target)
    if not (np.isfinite(float(loss)) and all(
            np.isfinite(np.asarray(g)).all() for g in grads)):
        raise RuntimeError("non-finite sharded soft loss or gradients")
    log(f"  sharded soft train step: loss {float(loss):.6f}")
    if not interpret:
        # Devices 1-3 hold nothing but their shards' work; a device that
        # did none would peak at the replicated scene's few KB.
        peaks = [d.memory_stats()["peak_bytes_in_use"] for d in devs]
        log(f"  peak bytes in use per device: {peaks}")
        if min(peaks) < 16 << 20:
            raise RuntimeError(f"not every device did its share: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default devices are "
              f"{devs[0].platform!r}); nothing was run", file=sys.stderr)
        return 1

    from raytracingproject_tpu.utils.cache import enable_compilation_cache
    from raytracingproject_tpu.utils.device import gpu_name_and_power

    enable_compilation_cache()
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    log(f"nvidia-smi: {gpu_name_and_power()}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_cli()
        phase_render()
        phase_train()
        phase_session()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
