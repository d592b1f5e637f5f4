"""Forward+backward benchmark: rays/s through a full inverse-rendering step
(render + pixel loss + gradient w.r.t. scene params + Adam update) — the
second BASELINE.md metric. Prints one JSON line per path. Requires a GPU;
prints the device and the card's name and power limit first.

Paths:
  xla            — reverse-mode through the XLA renderer (grad/inverse.py);
                   depth-8 configs only (at depth 50 the unrematerialized
                   scan residuals exceed device memory)
  fast           — megakernel forward + path-replay backward (grad/fast.py),
                   geometry+albedo trainable
  fast_materials — same path, materials-only trainable (albedo/fuzz/ior)

Depth-50 rows are the flagship operating point (src/main.cpp:57-60):
`fast` runs the default replay (plain scan + take-forward/one-hot-backward
gather); `fast_colT`, `fast_skip` and `fast_g8` are the alternative replay
forms (ray-minor gather, cond dead-skipping, death-depth-sorted grouping).

Methodology: N sequential steps form a true dependency chain closed by a
host fetch of the final loss; the marginal cost between two step counts
cancels fixed overheads (tools/measure.py). Each number is the median of
REPS marginals with the spread recorded in the artifact (bench_out/).
"""

from __future__ import annotations

import json
import os
import statistics
import time

import jax

from raytracingproject_tpu.utils.cache import enable_compilation_cache
from raytracingproject_tpu.utils.device import print_device_header

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.grad.fast import make_fast_train_step
from raytracingproject_tpu.grad.inverse import make_train_step, extract_params
from raytracingproject_tpu.render import render
from raytracingproject_tpu.scene import make_cover_scene, make_three_sphere_scene
from tools.measure import fresh_salt

# Marginal window: 12 extra steps keep dispatch jitter small against the
# measurement at the small configs.
N1, N2 = 4, 16
REPS = 3
TRAINABLE = ("albedo", "center0", "radius")
MATERIALS = ("albedo", "fuzz", "ior")

COVER_CAM = dict(vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                 defocus_angle=0.6, focus_dist=10.0)

# (label, scene factory, camera kwargs, width, spp, depth, n1, n2, reps).
# The two d8 rows are small configs; the d50 rows are the
# flagship operating point (the reference renders at depth 50).
CONFIGS = [
    ("three_sphere_200px_d8", make_three_sphere_scene,
     dict(vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0)),
     200, 4, 8, N1, N2, REPS),
    ("cover_200px_d8", lambda: make_cover_scene(seed=0), COVER_CAM,
     200, 2, 8, N1, N2, REPS),
    ("cover_400px_d50", lambda: make_cover_scene(seed=0), COVER_CAM,
     400, 2, 50, N1, N2, REPS),
    # flagship resolution; steps are ~seconds, so a smaller window/rep count
    ("cover_1200x675_d50", lambda: make_cover_scene(seed=0), COVER_CAM,
     1200, 1, 50, 2, 6, 3),
]

REPLAY_GROUPS = 8  # slices for dead-depth-skipping replay at depth 50


def time_steps(step, params0, opt0, target, n_steps: int) -> tuple[float, float]:
    key = jax.random.PRNGKey(fresh_salt())
    params, opt_state = params0, opt0
    t0 = time.perf_counter()
    for i in range(n_steps):
        params, opt_state, loss, _ = step(
            params, opt_state, jax.random.fold_in(key, i), target
        )
    final = float(loss)  # host fetch: the only true barrier here
    return time.perf_counter() - t0, final


def measure(step, params0, opt0, target, n1, n2, reps):
    """(median marginal sec/step, final loss, first loss, [marginals]).

    The first/final loss pair guards against a diverging optimization that
    empties the scene (spheres fly away, every path dies at bounce 1) and
    makes the "measured" step several times faster than honest work — a
    diverged row must be flagged, never quoted as throughput."""
    _, first = time_steps(step, params0, opt0, target, n1)  # compile/warm
    time_steps(step, params0, opt0, target, n2)
    marginals = []
    loss = float("nan")
    # reps + 1 cycles, the first discarded as warm-up.
    for i in range(reps + 1):
        d1, _ = time_steps(step, params0, opt0, target, n1)
        d2, loss = time_steps(step, params0, opt0, target, n2)
        if i == 0:
            continue
        if d2 <= d1:  # timing noise swamped the extra steps
            continue
        marginals.append((d2 - d1) / (n2 - n1))
    if not marginals:
        raise RuntimeError("all timing reps showed dt(N2) <= dt(N1)")
    return statistics.median(marginals), loss, first, marginals


def main() -> None:
    device = print_device_header()
    enable_compilation_cache()
    artifact: dict = {"device": device, "reps": REPS, "configs": {}}
    only = os.environ.get("FWDBWD_ONLY")  # comma-separated config filter
    for label, scene_fn, cam_kw, width, spp, depth, n1, n2, reps in CONFIGS:
        if only and label not in only.split(","):
            continue
        deep = depth > 16
        scene = scene_fn()
        cam = Camera(
            aspect_ratio=16.0 / 9.0,
            image_width=width,
            samples_per_pixel=spp,
            max_depth=depth,
            **cam_kw,
        )
        height = cam.image_height
        rays = width * height * spp
        # target at >=16 spp regardless of the training spp: a 1-spp MC
        # target is noisy enough that depth-50 geometry rows can diverge
        # even under clipping; a cleaner target changes nothing about the
        # per-step cost being measured
        target_cam = Camera(
            aspect_ratio=16.0 / 9.0, image_width=width,
            samples_per_pixel=max(spp, 16), max_depth=depth, **cam_kw,
        )
        target = render(scene, target_cam, jax.random.PRNGKey(0))

        # Gradient clipping for every row: a diverging run empties the
        # scene and inflates the measured rays/s. Depth-50 geometry
        # training is bistable at lr 2e-2 even clipped, so 2e-3 for deep
        # rows; the lr does not change the per-step cost being measured.
        import optax

        opt = optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adam(2e-3 if deep else 2e-2),
        )

        paths = {}
        if not deep:
            # XLA reverse-mode at depth 50 materializes ~[R, N] residuals
            # per bounce x 50 — past device memory at these sizes; d8 only.
            opt_state, step = make_train_step(scene, cam, opt, spp=spp,
                                               trainable=TRAINABLE)
            paths["xla"] = (step, extract_params(scene), opt_state)
        fp, fo, fstep = make_fast_train_step(
            scene, cam, opt, spp=spp, trainable=TRAINABLE,
        )
        paths["fast"] = (fstep, fp, fo)
        if deep:
            # the alternative replay forms: the ray-minor one-hot gather,
            # the cond-predicated dead-skip, the death-depth-sorted grouping
            cp, co, cstep = make_fast_train_step(
                scene, cam, opt, spp=spp, trainable=TRAINABLE,
                replay_gather="colT",
            )
            paths["fast_colT"] = (cstep, cp, co)
            nsp, nso, nsstep = make_fast_train_step(
                scene, cam, opt, spp=spp, trainable=TRAINABLE,
                replay_skip_dead=True,
            )
            paths["fast_skip"] = (nsstep, nsp, nso)
            g8p, g8o, g8step = make_fast_train_step(
                scene, cam, opt, spp=spp, trainable=TRAINABLE,
                replay_groups=REPLAY_GROUPS,
            )
            paths["fast_g8"] = (g8step, g8p, g8o)
        bp, bo, bstep = make_fast_train_step(
            scene, cam, opt, spp=spp, trainable=MATERIALS,
        )
        paths["fast_materials"] = (bstep, bp, bo)

        results = {}
        flags = {}
        entry: dict = {}
        for name, (step, params0, opt0) in paths.items():
            try:
                sec, loss, first, marginals = measure(step, params0, opt0,
                                                      target, n1, n2, reps)
            except Exception as e:
                # one path running out of memory or failing to compile must
                # not lose the other rows or the artifact
                entry[name + "_error"] = str(e).split("\n")[0][:140]
                print(json.dumps({"metric": f"fwd_bwd_{label}_{name}",
                                  "error": entry[name + "_error"]}),
                      flush=True)
                continue
            diverged = not (loss == loss) or loss > 3.0 * max(first, 1e-6)
            results[name] = rays / sec
            flags[name] = diverged
            entry[name] = round(rays / sec, 1)
            entry[name + "_spread_mrays"] = [
                round(rays / m / 1e6, 2) for m in sorted(marginals)
            ]
            if diverged:
                entry[name + "_diverged"] = True
            print(
                json.dumps(
                    {
                        "metric": f"fwd_bwd_rays_per_sec_{label}_{name}",
                        "value": round(rays / sec, 1),
                        "unit": "rays/s",
                        "step_ms": round(sec * 1e3, 2),
                        "reps": len(marginals),
                        "spread_mrays": entry[name + "_spread_mrays"],
                        "final_loss": loss,
                        "first_loss": first,
                        "diverged": diverged,
                    }
                ),
                flush=True,
            )
        def ratio(num, den, key):
            """Record a ratio only from clean rows: flagged (diverged) rows
            are never quoted."""
            if num in results and den in results:
                if flags[num] or flags[den]:
                    entry[key + "_suppressed"] = "diverged row"
                    return
                entry[key] = round(results[num] / results[den], 3)
                print(json.dumps({
                    "metric": f"{key}_fwd_bwd_{label}",
                    "value": entry[key],
                    "unit": "x",
                }), flush=True)

        ratio("fast", "xla", "fast_over_xla")
        ratio("fast", "fast_skip", "fast_over_skip")
        ratio("fast_colT", "fast", "colT_over_fast")
        artifact["configs"][label] = entry

    # the second BASELINE metric (fwd+bwd rays/s), one record per run
    from tools.artifact import artifact_path

    out = os.environ.get("FWDBWD_ARTIFACT", artifact_path("FWDBWD"))
    if only and os.path.exists(out):
        # a filtered rerun (FWDBWD_ONLY) updates its configs in place
        # instead of dropping the others from the artifact
        with open(out) as f:
            prev = json.load(f)
        prev.get("configs", {}).update(artifact["configs"])
        artifact = {**prev, **{k: v for k, v in artifact.items()
                               if k != "configs"},
                    "configs": prev["configs"]}
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps({"artifact": out}), flush=True)


if __name__ == "__main__":
    main()
