"""CONFIG5's training story at reduced scale on the virtual mesh: a real
sharded geometry+albedo training run — not a dryrun — on the 8-device CPU
mesh, with loss descent and parameter recovery recorded.

The full config 5 (4K, 512 spp, many devices) needs a cluster; this is a
CPU-only check of the composition: the same make_sharded_train_step
composition (pixels over `rays`, spp over `samples`, params replicated,
grads psum-ed by the shard_map transpose) driven for N steps at a
CPU-tractable scale, recovering perturbed geometry+albedo toward a target
render. Writes bench_out/CONFIG5VM.json.

Run: python -m tools.config5_vmesh [width] [steps]   (CPU only)
"""

from __future__ import annotations

import json
import os
import sys

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.grad.inverse import extract_params
from raytracingproject_tpu.parallel import make_mesh, make_sharded_train_step, render_sharded
from raytracingproject_tpu.scene import make_cover_scene

COVER_CAM = dict(vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
                 defocus_angle=0.6, focus_dist=10.0)
TRAINABLE = ("center0", "radius", "albedo")  # geometry + albedo


def main() -> None:
    width = int(sys.argv[1]) if len(sys.argv) > 1 else 480
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 24
    spp = 8
    depth = 8
    assert jax.devices()[0].platform == "cpu"
    mesh = make_mesh(devices=jax.devices()[:8], samples_axis_size=2)

    scene = make_cover_scene(seed=0)
    cam = Camera(aspect_ratio=16.0 / 9.0, image_width=width,
                 samples_per_pixel=spp, max_depth=depth, **COVER_CAM)
    height = cam.image_height
    rays_per_step = width * height * spp

    # target: the TRUE scene rendered on the same mesh
    target = render_sharded(scene, cam, jax.random.PRNGKey(0), mesh)

    # start point: perturb geometry + albedo of the three big spheres'
    # neighborhood (every sphere gets small noise; the optimizer must walk
    # the whole parameter set back)
    rng = np.random.default_rng(1)
    n = int(scene.radius.shape[0])
    pert = scene._replace(
        center0=scene.center0 + jnp.asarray(
            rng.normal(0, 0.03, (n, 3)).astype(np.float32)),
        radius=scene.radius * jnp.asarray(
            1.0 + rng.normal(0, 0.03, n).astype(np.float32)),
        albedo=jnp.clip(scene.albedo + jnp.asarray(
            rng.normal(0, 0.05, (n, 3)).astype(np.float32)), 0.0, 1.0),
    )

    import optax

    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(5e-3))
    params, opt_state, step = make_sharded_train_step(
        pert, cam, mesh, opt, spp=spp, trainable=TRAINABLE,
    )
    p0 = extract_params(pert)
    true_p = extract_params(scene)

    def param_err(p):
        return float(
            jnp.linalg.norm(p.center0 - true_p.center0)
            + jnp.linalg.norm(p.radius - true_p.radius)
            + jnp.linalg.norm(p.albedo - true_p.albedo)
        )

    losses = []
    key = jax.random.PRNGKey(7)
    for s in range(steps):
        params, opt_state, loss, _ = step(
            params, opt_state, jax.random.fold_in(key, s), target
        )
        losses.append(float(loss))
        print(json.dumps({"step": s, "loss": losses[-1]}), flush=True)

    out = {
        "mesh": dict(mesh.shape),
        "backend": "cpu_virtual8",
        "config": f"cover_{width}x{height}_spp{spp}_d{depth}",
        "trainable": list(TRAINABLE),
        "steps": steps,
        "rays_per_step": rays_per_step,
        "loss_curve": [round(l, 6) for l in losses],
        "loss_first": round(losses[0], 6),
        "loss_final": round(losses[-1], 6),
        "loss_drop_pct": round(100 * (1 - losses[-1] / losses[0]), 2),
        "param_err_initial": round(param_err(p0), 4),
        "param_err_final": round(param_err(params), 4),
        "note": "virtual CPU mesh: evidences the sharded config-5 training "
                "composition (loss descent + param recovery), not throughput",
    }
    assert losses[-1] < losses[0], "loss did not descend"

    from tools.artifact import artifact_path

    path = artifact_path("CONFIG5VM")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"artifact": path,
                      "loss_drop_pct": out["loss_drop_pct"],
                      "param_err": [out["param_err_initial"],
                                    out["param_err_final"]]}), flush=True)


if __name__ == "__main__":
    main()
