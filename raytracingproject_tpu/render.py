"""The megakernel renderer: jitted, differentiable path tracing.

The reference's recursive `ray_color` (src/camera_cpu.h:8-26) becomes a
`lax.scan` over bounce depth carrying (origin, direction, throughput,
radiance, alive). All rays advance in lockstep; terminated rays are masked.
This is the correctness oracle and the gradient path; the GPU megakernel
(ops/pallas/megakernel.py) is validated against it.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracingproject_tpu.camera import Camera, CameraDerived, generate_rays
from raytracingproject_tpu.config import RenderSettings, T_MIN
from raytracingproject_tpu.materials import scatter
from raytracingproject_tpu.ops.intersect import closest_hit
from raytracingproject_tpu.ops.vecmath import normalize
from raytracingproject_tpu.scene import Scene

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)


def sky_color(direction: jnp.ndarray, sky_tex: jnp.ndarray | None = None) -> jnp.ndarray:
    """Background radiance for a miss ray.

    Default: the reference's gradient (src/camera_cpu.h:23-25):
    lerp(white, (0.5,0.7,1.0)) by 0.5*(unit_dir.y + 1).

    With `sky_tex` ([Ht, Wt, 3] linear float): an equirectangular
    environment-map lookup (bilinear in the texture plane). This is the
    path-tracing role for the session's `add_texture` (the reference loads,
    transitions, and *displays* its texture, src/vulkan/texture.cpp:9-43 +
    frag binding 1; here the honest path-tracing equivalent is an
    environment light sampled on miss)."""
    unit = normalize(direction, eps=1e-12)
    if sky_tex is None:
        a = 0.5 * (unit[..., 1] + 1.0)
        white = jnp.asarray(SKY_WHITE, direction.dtype)
        blue = jnp.asarray(SKY_BLUE, direction.dtype)
        return (1.0 - a)[..., None] * white + a[..., None] * blue

    ht, wt = sky_tex.shape[0], sky_tex.shape[1]
    # equirectangular: u from azimuth, v from polar angle (y-up)
    u = 0.5 + jnp.arctan2(unit[..., 2], unit[..., 0]) / (2.0 * jnp.pi)
    v = jnp.arccos(jnp.clip(unit[..., 1], -1.0, 1.0)) / jnp.pi
    x = u * (wt - 1)
    y = v * (ht - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, wt - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, ht - 1)
    x1 = jnp.minimum(x0 + 1, wt - 1)
    y1 = jnp.minimum(y0 + 1, ht - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = sky_tex.reshape(-1, 3)
    c00 = jnp.take(flat, y0 * wt + x0, axis=0)
    c01 = jnp.take(flat, y0 * wt + x1, axis=0)
    c10 = jnp.take(flat, y1 * wt + x0, axis=0)
    c11 = jnp.take(flat, y1 * wt + x1, axis=0)
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy).astype(direction.dtype)


class _PathState(NamedTuple):
    origin: jnp.ndarray      # [R, 3]
    direction: jnp.ndarray   # [R, 3]
    throughput: jnp.ndarray  # [R, 3] product of attenuations so far
    radiance: jnp.ndarray    # [R, 3] accumulated light
    alive: jnp.ndarray       # [R] bool — still bouncing


def _bounce(
    scene: Scene,
    time: jnp.ndarray,
    state: _PathState,
    key: jax.Array,
    bvh=None,
    sky_tex: jnp.ndarray | None = None,
) -> _PathState:
    """One bounce of every live ray: closest hit (brute-force scan or BVH
    traversal), scatter or sky."""
    if bvh is not None:
        from raytracingproject_tpu.bvh import bvh_closest_hit

        rec = bvh_closest_hit(
            state.origin, state.direction, time, scene, bvh, t_min=T_MIN
        )
    else:
        rec = closest_hit(
            state.origin,
            state.direction,
            time,
            scene.center0,
            scene.center_delta,
            scene.radius,
            t_min=T_MIN,
        )
    sc = scatter(key, state.direction, rec, scene)

    miss = state.alive & ~rec.hit
    # On miss: add throughput * sky and retire (src/camera_cpu.h:23-25).
    radiance = state.radiance + jnp.where(
        miss[..., None], state.throughput * sky_color(state.direction, sky_tex), 0.0
    )
    # On hit: multiply throughput by attenuation; absorb (metal below
    # hemisphere) retires the ray with no contribution (src/camera_cpu.h:20).
    hit_live = state.alive & rec.hit
    throughput = jnp.where(
        hit_live[..., None], state.throughput * sc.attenuation, state.throughput
    )
    alive = hit_live & sc.scattered

    origin = jnp.where(hit_live[..., None], rec.p, state.origin)
    direction = jnp.where(hit_live[..., None], sc.direction, state.direction)
    return _PathState(origin, direction, throughput, radiance, alive)


def ray_color(
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    time: jnp.ndarray,
    key: jax.Array,
    max_depth: int,
    bvh=None,
    early_exit: bool = False,
    sky_tex: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Radiance for a batch of rays — iterative counterpart of the
    reference's depth-limited recursion (src/camera_cpu.h:8-26). Rays still
    alive after `max_depth` bounces contribute black (depth exhausted).

    `bvh` (a FlatBVH built over `scene` — scene must already be in leaf
    order, see bvh.reorder_scene) switches closest-hit to the stackless
    traversal; forward-only (while_loop is not reverse-differentiable).

    `early_exit=True` runs the bounce loop as a while_loop that stops when
    every ray has terminated — identical radiance (bounce k consumes the
    same fold_in(key, k) stream either way), but typical scenes finish in
    2-4 bounces, not max_depth. Forward-only."""
    n = origin.shape[0]
    dtype = origin.dtype
    state = _PathState(
        origin=origin,
        direction=direction,
        throughput=jnp.ones((n, 3), dtype),
        radiance=jnp.zeros((n, 3), dtype),
        alive=jnp.ones((n,), bool),
    )

    if early_exit:
        def cond(carry):
            depth, state = carry
            return (depth < max_depth) & jnp.any(state.alive)

        def body(carry):
            depth, state = carry
            k = jax.random.fold_in(key, depth)
            return depth + 1, _bounce(scene, time, state, k, bvh, sky_tex)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
        return state.radiance

    def step(state, depth):
        k = jax.random.fold_in(key, depth)
        return _bounce(scene, time, state, k, bvh, sky_tex), None

    state, _ = jax.lax.scan(step, state, jnp.arange(max_depth))
    return state.radiance


MEGAKERNEL_BVH_ERROR = (
    "use_megakernel with use_bvh: no GPU kernel traverses a BVH yet; use "
    "the megakernel's brute-force scan (use_bvh=False) or the XLA BVH "
    "traversal (use_megakernel=False)"
)


@lru_cache(maxsize=None)
def _block_order(width: int, height: int, spp: int = 1, tile: int = 128):
    """(slot_pix, gather): ray ordering that feeds the megakernel in compact
    screen blocks.

    The kernel processes rays in consecutive `tile`-ray blocks (its BLOCK).
    Here rays are ordered block-by-block — all `spp` samples of one bxb
    pixel block consecutively — with b chosen so one pixel block's rays
    fill about one kernel block, so the rays a program traces start close
    together on screen.

    `slot_pix[r]` is the row-major pixel id ray slot r renders (padded to a
    `tile` multiple with pixel 0, dropped on unpermute); `gather[s, p]` is
    the slot of (sample s, pixel p), so `rad[gather]` restores [spp, H*W]
    row-major order. render() accumulates in slot space across sample
    chunks (render_pass(raw_slots=True)) and unpermutes once per frame."""
    import numpy as np

    b = 32
    while b > 8 and b * b * spp > tile:
        b //= 2
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    slots = []
    gather = np.empty((spp, width * height), np.int64)
    pos = 0
    for by in range(0, height, b):
        for bx in range(0, width, b):
            blk = idx[by : by + b, bx : bx + b].reshape(-1)
            for s in range(spp):
                gather[s, blk] = pos + np.arange(blk.size)
                slots.append(blk)
                pos += blk.size
    slot_pix = np.concatenate(slots)
    pad = (-slot_pix.size) % tile
    if pad:
        slot_pix = np.concatenate([slot_pix, np.zeros(pad, np.int64)])
    return slot_pix.astype(np.int32), gather.astype(np.int32)


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_depth", "spp_chunk", "early_exit",
        "use_megakernel", "raw_slots", "interpret",
    ),
)
def render_pass(
    scene: Scene,
    cam: CameraDerived,
    key: jax.Array,
    *,
    width: int,
    height: int,
    max_depth: int,
    spp_chunk: int = 1,
    bvh=None,
    early_exit: bool = False,
    use_megakernel: bool = False,
    sky_tex: jnp.ndarray | None = None,
    raw_slots: bool = False,
    interpret: bool = False,
) -> jnp.ndarray:
    """`spp_chunk` samples of every pixel; returns the radiance *sum*
    [H, W, 3] over the chunk (caller divides by total spp, as
    src/color.h:20-22).

    `use_megakernel=True` runs the full bounce loop inside one GPU kernel
    (ops/pallas/megakernel.py): rays stay in registers from camera ray to
    radiance. Forward-only; brute-force closest hit (no `bvh`). It needs a
    GPU backend, or `interpret=True` for Pallas's interpreter (tests).
    """
    if raw_slots and not use_megakernel:
        raise ValueError("raw_slots (slot-space output) is a megakernel-"
                         "path option; the XLA paths return [H, W, 3]")
    if use_megakernel and bvh is not None:
        raise ValueError(MEGAKERNEL_BVH_ERROR)
    jj, ii = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    k_ray, k_path = jax.random.split(key)
    if use_megakernel:
        from raytracingproject_tpu.ops.pallas.megakernel import (
            BLOCK, pallas_trace_paths,
        )

        # Feed rays in compact screen blocks (all samples of one block
        # consecutively) — see _block_order. Padding rays re-render pixel
        # (0,0) and are dropped by the gather.
        slot_pix, gather = _block_order(width, height, spp_chunk, BLOCK)
        i = ii.reshape(-1)[slot_pix]
        j = jj.reshape(-1)[slot_pix]
        origin, direction, time = generate_rays(cam, i, j, k_ray)
        seed = jax.random.randint(k_path, (), 0, 2**31 - 1, dtype=jnp.int32)
        # With a sky texture the kernel records (miss dir, miss throughput)
        # instead of adding the built-in gradient; the equirect env-map
        # lookup happens here in XLA (one vectorized gather over rays).
        record_miss = sky_tex is not None
        out = pallas_trace_paths(
            origin, direction, time, scene, seed, max_depth,
            interpret=interpret, record_miss=record_miss,
        )
        if record_miss:
            rad, mdir, mthr = out
            rad = rad + mthr * sky_color(mdir, sky_tex)
        else:
            rad = out
        if raw_slots:
            # slot-space radiance: the caller accumulates chunks here and
            # unpermutes once per frame (blocks_to_image)
            return rad
        rad = rad[jnp.asarray(gather)]  # [spp_chunk, H*W, 3] row-major
        return rad.sum(axis=0).reshape(height, width, 3)

    i = jnp.tile(ii.reshape(-1), spp_chunk)
    j = jnp.tile(jj.reshape(-1), spp_chunk)
    origin, direction, time = generate_rays(cam, i, j, k_ray)
    rad = ray_color(
        scene, origin, direction, time, k_path, max_depth, bvh, early_exit,
        sky_tex,
    )
    return rad.reshape(spp_chunk, height, width, 3).sum(axis=0)


@partial(jax.jit, static_argnames=("width", "height", "spp_chunk"))
def blocks_to_image(
    slot_rad: jnp.ndarray, width: int, height: int, spp_chunk: int
) -> jnp.ndarray:
    """Slot-space radiance sum [R_pad, 3] (render_pass(raw_slots=True),
    possibly accumulated over many chunks) -> row-major image sum
    [H, W, 3]. One gather per frame instead of one per pass."""
    from raytracingproject_tpu.ops.pallas.megakernel import BLOCK

    _, gather = _block_order(width, height, spp_chunk, BLOCK)
    return slot_rad[jnp.asarray(gather)].sum(axis=0).reshape(height, width, 3)


def render(
    scene: Scene,
    camera: Camera,
    key: jax.Array | None = None,
    settings: RenderSettings | None = None,
    sky_texture: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Full render: mean radiance image [H, W, 3] in linear space.

    Equivalent of `camera::render` (src/camera.h:32-50) minus the PPM
    output — use `color.to_u8` + `utils.ppm.write_ppm` for that. Sample
    passes are chunked so each device batch stays at a static size.
    """
    settings = settings or RenderSettings()
    use_megakernel = settings.use_megakernel
    if use_megakernel and settings.use_bvh:
        raise ValueError(MEGAKERNEL_BVH_ERROR)
    key = key if key is not None else jax.random.PRNGKey(0)
    width, height = camera.image_size()
    cam = camera.derive(settings.dtype)
    spp = camera.samples_per_pixel

    bvh = None
    if settings.use_bvh:
        from raytracingproject_tpu.bvh import build_bvh, reorder_scene

        bvh = build_bvh(scene, leaf_size=settings.bvh_leaf_size)
        scene = reorder_scene(scene, bvh)

    pixels = width * height
    spp_chunk = max(1, min(spp, settings.rays_per_batch // max(pixels, 1)))

    acc = jnp.zeros((height, width, 3), settings.dtype)
    # Megakernel chunks accumulate in slot space (ray feed order) and
    # unpermute once at the end.
    slot_acc = None
    done = 0
    chunks = 0
    while done < spp:
        chunk = min(spp_chunk, spp - done)
        k = jax.random.fold_in(key, done)
        raw = use_megakernel and chunk == spp_chunk
        out = render_pass(
            scene,
            cam,
            k,
            width=width,
            height=height,
            max_depth=camera.max_depth,
            spp_chunk=chunk,
            bvh=bvh,
            early_exit=True,
            use_megakernel=use_megakernel,
            sky_tex=sky_texture,
            raw_slots=raw,
        )
        if raw:
            slot_acc = out if slot_acc is None else slot_acc + out
            sync_target = slot_acc
        else:
            acc = acc + out
            sync_target = acc
        done += chunk
        chunks += 1
        if settings.sync_every and chunks % settings.sync_every == 0 and done < spp:
            sync_target.block_until_ready()
    if slot_acc is not None:
        acc = acc + blocks_to_image(slot_acc, width, height, spp_chunk)
    return acc / spp


def render_image(
    scene: Scene,
    camera: Camera,
    key: jax.Array | None = None,
    settings: RenderSettings | None = None,
    sky_texture: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Render and quantize to uint8 [H, W, 3] (gamma + clamp per
    src/color.h:14-35)."""
    from raytracingproject_tpu.color import to_u8

    return to_u8(render(scene, camera, key, settings, sky_texture))
