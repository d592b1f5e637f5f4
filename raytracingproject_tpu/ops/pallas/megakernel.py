"""Full-path megakernel: the whole bounce loop of the path tracer in one GPU
kernel, written in Pallas for the Triton route (`backend="triton"`).

One program traces a block of BLOCK rays from camera ray to final radiance.
The ray state lives in registers across bounces, so nothing round-trips
through device memory between bounces (the megakernel design of SURVEY.md
§7, tier (b)). Per bounce the kernel does everything render.ray_color does:

- closest hit: a rolled `fori_loop` over the sphere table, the linear scan of
  src/hittable_list.h:25-39. Each sphere's attributes are scalar loads from
  a [N_ROWS, N] table small enough to stay in L1 for the block; the
  winner's attributes are selected into registers as the scan goes, so the
  shading needs no gather;
- scatter: lambertian / metal / dielectric with Schlick, reproducing
  src/material.h:16-81;
- RNG: a counter-based hash (`_pcg4d`) of (seed, global ray index, bounce)
  whose four output words are the bounce's four draws. The stream depends
  on neither the block size nor the order in which blocks run, so tuning
  BLOCK never changes an image;
- sky on miss, and depth-limited termination with a per-block early exit:
  the depth loop runs while any ray of the block is alive.

`pallas_trace_record` also writes the per-bounce path decisions that the
path-replay backward (grad/replay.py) differentiates.

The kernel is forward-only and draws other random numbers than the XLA
renderer, so it is validated statistically against render.ray_color (and
exactly wherever a path consumes no randomness).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from raytracingproject_tpu.config import T_MIN, T_MAX, LAMBERTIAN, METAL, DIELECTRIC
from raytracingproject_tpu.scene import Scene

# Rays per program: a power of two (Triton's block rule), one ray per
# thread. Of 32 / 64 / 128 / 256, 32 (one warp) measured fastest on an H100
# at the cover scene, depth 50 (PERF.md): the smaller the block, the sooner
# its depth loop ends with its last live ray.
BLOCK = 32
# Spheres tested per iteration of the closest-hit loop.
UNROLL = 8

# sphere table rows: cx cy cz mx my mz rad mat alb_r alb_g alb_b fuzz ior
ROW_CX, ROW_CY, ROW_CZ = 0, 1, 2
ROW_MX, ROW_MY, ROW_MZ = 3, 4, 5
ROW_RAD, ROW_MAT = 6, 7
ROW_AR, ROW_AG, ROW_AB = 8, 9, 10
ROW_FUZZ, ROW_IOR = 11, 12
N_ROWS = 16  # 13 attribute rows padded to a power of two

# Residual code per bounce: 2 * idx + reflect_bit, with idx >= 0 the hit
# sphere, -1 miss, -2 dead (grad/replay.py's MISS and DEAD).
CODE_MISS = -2
CODE_DEAD = -4


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _check_backend(interpret: bool) -> None:
    """The kernel is compiled for the GPU only; elsewhere the caller must
    ask for Pallas's interpreter explicitly (tests do)."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the megakernel is compiled for the GPU (Pallas, Triton route); "
            f"the default backend is {jax.default_backend()!r}. Use the XLA "
            "renderer there, or pass interpret=True to run Pallas's "
            "interpreter."
        )


# ---------------------------------------------------------------------------
# Counter-based RNG
# ---------------------------------------------------------------------------

def _pcg4d(x, y, z, w):
    """pcg4d of Jarzynski and Olano, "Hash Functions for GPU Rendering",
    JCGT 9(3), 2020: four uint32 words in, four mixed uint32 words out.
    uint32 arithmetic wraps, as the hash requires."""
    m = jnp.uint32(1664525)
    c = jnp.uint32(1013904223)
    x = x * m + c
    y = y * m + c
    z = z * m + c
    w = w * m + c
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _unit_float(bits):
    """U[0,1) from the top 24 bits of a uint32 (exact in float32)."""
    return (bits >> 8).astype(jnp.float32) * (1.0 / (1 << 24))


def draws(seed, ray, bounce):
    """The four U[0,1) draws of rays `ray` (uint32 [B]) at `bounce`: draw
    slot k is output word k of pcg4d(ray, bounce, seed, 0). Used inside
    the kernel and by the tests of the stream."""
    ray = ray.astype(jnp.uint32)
    bounce = jnp.broadcast_to(jnp.asarray(bounce).astype(jnp.uint32), ray.shape)
    seed = jnp.broadcast_to(jnp.asarray(seed).astype(jnp.uint32), ray.shape)
    return tuple(_unit_float(b) for b in _pcg4d(ray, bounce, seed, jnp.zeros_like(ray)))


def _unit_vector(u_z, u_phi):
    """Uniform directions on S^2 via the cylinder map (Archimedes): z
    uniform in [-1, 1], azimuth uniform — the distribution of
    src/vec3.h:137-139."""
    z = 2.0 * u_z - 1.0
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    th = (2.0 * jnp.pi) * u_phi
    return s * jnp.cos(th), s * jnp.sin(th), z


def _ball_radius(u):
    """Radius CDF^-1 for uniform-in-ball sampling, u^(1/3):
    unit_vector * ball_radius is the src/vec3.h:129-135 distribution."""
    u = jnp.maximum(u, 1e-30)
    return jnp.exp(jnp.log(u) * (1.0 / 3.0))


# ---------------------------------------------------------------------------
# Closest hit
# ---------------------------------------------------------------------------

def _sphere_test(sph_ref, s, rays, hc, t_min):
    """Test sphere `s` against the block of rays and update the carry
    (best t, winner index, winner attributes). Exact reference quadratic
    (src/sphere.h:30-57) over the open t-interval, with the moving-sphere
    centre lerp (src/sphere.h:68-72)."""
    ox, oy, oz, dx, dy, dz, tm, a, inv_a = rays
    (bt, hidx, hx, hy, hz, hrad, hmat, har, hag, hab, hfz, hio) = hc

    def ld(row):
        return sph_ref[row, s]

    rad = ld(ROW_RAD)
    ccx = ld(ROW_CX) + tm * ld(ROW_MX)
    ccy = ld(ROW_CY) + tm * ld(ROW_MY)
    ccz = ld(ROW_CZ) + tm * ld(ROW_MZ)
    ocx = ox - ccx
    ocy = oy - ccy
    ocz = oz - ccz
    half_b = ocx * dx + ocy * dy + ocz * dz
    cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = half_b * half_b - a * cq
    dpos = disc > 0.0
    sq = jnp.sqrt(jnp.where(dpos, disc, 1.0))
    r0 = (-half_b - sq) * inv_a
    r1 = (-half_b + sq) * inv_a
    in0 = (r0 > t_min) & (r0 < bt)
    in1 = (r1 > t_min) & (r1 < bt)
    root = jnp.where(in0, r0, r1)
    better = dpos & (in0 | in1)

    return (
        jnp.where(better, root, bt),
        jnp.where(better, s, hidx),
        jnp.where(better, ccx, hx),
        jnp.where(better, ccy, hy),
        jnp.where(better, ccz, hz),
        jnp.where(better, rad, hrad),
        jnp.where(better, ld(ROW_MAT), hmat),
        jnp.where(better, ld(ROW_AR), har),
        jnp.where(better, ld(ROW_AG), hag),
        jnp.where(better, ld(ROW_AB), hab),
        jnp.where(better, ld(ROW_FUZZ), hfz),
        jnp.where(better, ld(ROW_IOR), hio),
    )


def _hit_init(shape):
    zeros = jnp.zeros(shape, jnp.float32)
    ones = jnp.ones(shape, jnp.float32)
    return (jnp.full(shape, T_MAX, jnp.float32), jnp.full(shape, -1, jnp.int32),
            zeros, zeros, zeros, ones, zeros, zeros, zeros, zeros, zeros, ones)


def _closest_hit(sph_ref, rays, t_min, n_spheres, shape):
    """Linear scan (src/hittable_list.h:25-39): every sphere against every
    ray of the block, UNROLL spheres per loop iteration."""
    n_main = (n_spheres // UNROLL) * UNROLL

    def body(q, hc):
        for u in range(UNROLL):
            hc = _sphere_test(sph_ref, q * UNROLL + u, rays, hc, t_min)
        return hc

    hc = jax.lax.fori_loop(0, n_main // UNROLL, body, _hit_init(shape))
    for s in range(n_main, n_spheres):  # static remainder
        hc = _sphere_test(sph_ref, jnp.int32(s), rays, hc, t_min)
    return hc


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _megakernel(seed_ref, sph_ref, *refs, n_spheres: int, max_depth: int,
                t_min: float, block: int, inject_bug=None,
                record_miss: bool = False, record: bool = False):
    """Depth loop of (closest hit -> shade/scatter) over one block of rays.

    refs: 7 ray planes (ox oy oz dx dy dz time, [B] each), 3 radiance
    outputs, then 6 miss outputs (`record_miss`) or 4 residual outputs
    (`record`).

    `record_miss`: the built-in sky gradient is not accumulated; instead the
    direction and throughput at the (unique) miss are written, and the
    caller adds thr * sky(dir) outside the kernel. That is how the
    equirectangular environment map (render.sky_color with a texture) rides
    the kernel.

    `record`: residual planes (code, ndx, ndy, ndz), [D_pad, B] blocks, one
    row per bounce: code = 2 * winner + reflect_bit on hits, CODE_MISS,
    CODE_DEAD; nd* the scattered direction on hits, 0 elsewhere."""
    ray_refs, out_refs = refs[:7], refs[7:]
    rad_refs = out_refs[:3]
    miss_refs = out_refs[3:9] if record_miss else None
    res_refs = out_refs[3:7] if record else None

    seed = seed_ref[0]
    ray_id = pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
    ox, oy, oz, dx, dy, dz, tm = (r[...] for r in ray_refs)

    shape = (block,)
    ones = jnp.ones(shape, jnp.float32)
    zeros = jnp.zeros(shape, jnp.float32)
    n_miss = 6 if record_miss else 0

    def bounce(dep, carry):
        (ox, oy, oz, dx, dy, dz, thr_r, thr_g, thr_b, rad_r, rad_g, rad_b,
         alive) = carry[:13]
        miss_c = carry[13:]

        a = jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-20)
        rays = (ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a)
        (bt, hidx, hx, hy, hz, hrad, hmat, har, hag, hab, hfz, hio) = (
            _closest_hit(sph_ref, rays, t_min, n_spheres, shape))

        hit = bt < T_MAX
        t_safe = jnp.where(hit, bt, 1.0)
        px = ox + t_safe * dx
        py = oy + t_safe * dy
        pz = oz + t_safe * dz
        inv_r = 1.0 / jnp.where(hrad != 0.0, hrad, 1.0)
        nx = (px - hx) * inv_r   # outward normal (src/sphere.h:52)
        ny = (py - hy) * inv_r
        nz = (pz - hz) * inv_r
        front = dx * nx + dy * ny + dz * nz < 0.0    # src/hittable.h:15-21
        sgn = jnp.where(front, 1.0, -1.0)
        nx = nx * sgn
        ny = ny * sgn
        nz = nz * sgn

        # ---- sky on miss (src/camera_cpu.h:23-25) ----
        inv_len = jax.lax.rsqrt(a)
        miss = alive & ~hit
        if record_miss:
            miss_c = tuple(jnp.where(miss, v, m) for v, m in
                           zip((dx, dy, dz, thr_r, thr_g, thr_b), miss_c))
        else:
            m = jnp.where(miss, 1.0, 0.0)
            sky_a = 0.5 * (dy * inv_len + 1.0)
            rad_r = rad_r + m * thr_r * (1.0 - sky_a + sky_a * 0.5)
            rad_g = rad_g + m * thr_g * (1.0 - sky_a + sky_a * 0.7)
            rad_b = rad_b + m * thr_b * (1.0 - sky_a + sky_a * 1.0)

        # ---- scatter (src/material.h) ----
        u_z, u_phi, u_ball, u_refl = draws(seed, ray_id, dep)
        udx = dx * inv_len
        udy = dy * inv_len
        udz = dz * inv_len

        # lambertian: normal + unit vector
        uvx, uvy, uvz = _unit_vector(u_z, u_phi)
        lam_x = nx + uvx
        lam_y = ny + uvy
        lam_z = nz + uvz

        # metal: reflect(unit_dir) + fuzz * in_unit_sphere. The ball point
        # reuses the same unit vector scaled by the ball-radius CDF^-1: a ray
        # hits exactly one material, so the lambertian and metal variants are
        # never both consumed, and the ball point is exactly
        # src/vec3.h:129-135 distributed.
        u_dot_n = udx * nx + udy * ny + udz * nz
        rfl_x = udx - 2.0 * u_dot_n * nx
        rfl_y = udy - 2.0 * u_dot_n * ny
        rfl_z = udz - 2.0 * u_dot_n * nz
        br = _ball_radius(u_ball)
        met_x = rfl_x + hfz * (uvx * br)
        met_y = rfl_y + hfz * (uvy * br)
        met_z = rfl_z + hfz * (uvz * br)
        met_ok = (met_x * nx + met_y * ny + met_z * nz) > 0.0

        # dielectric: refract-or-reflect with Schlick (src/material.h:55-71)
        ratio = jnp.where(front, 1.0 / hio, hio)
        cos_t = jnp.minimum(-u_dot_n, 1.0)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        cannot = ratio * sin_t > 1.0
        r0s = (1.0 - ratio) / (1.0 + ratio)
        r0s = r0s * r0s
        one_m = 1.0 - cos_t
        if inject_bug == "schlick3":
            # fault injection (test fixture): wrong Schlick exponent — the
            # per-material-region statistics test must detect this
            schlick = r0s + (1.0 - r0s) * one_m * one_m * one_m
        else:
            schlick = r0s + (1.0 - r0s) * one_m * one_m * one_m * one_m * one_m
        do_refl = cannot | (schlick > u_refl)
        # refract (src/vec3.h:153-158)
        perp_x = ratio * (udx + cos_t * nx)
        perp_y = ratio * (udy + cos_t * ny)
        perp_z = ratio * (udz + cos_t * nz)
        k = jnp.abs(1.0 - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z))
        spar = -jnp.sqrt(k)
        die_x = jnp.where(do_refl, rfl_x, perp_x + spar * nx)
        die_y = jnp.where(do_refl, rfl_y, perp_y + spar * ny)
        die_z = jnp.where(do_refl, rfl_z, perp_z + spar * nz)

        is_lam = hmat == float(LAMBERTIAN)
        is_met = hmat == float(METAL)
        is_die = hmat == float(DIELECTRIC)
        sx = jnp.where(is_lam, lam_x, jnp.where(is_met, met_x, die_x))
        sy = jnp.where(is_lam, lam_y, jnp.where(is_met, met_y, die_y))
        sz = jnp.where(is_lam, lam_z, jnp.where(is_met, met_z, die_z))
        scattered = ~is_met | met_ok

        hit_live = alive & hit
        if record:
            code_ref, ndx_ref, ndy_ref, ndz_ref = res_refs
            refl_bit = jnp.where(is_die & do_refl, 1, 0)
            code_ref[dep, :] = jnp.where(
                hit_live, 2 * hidx + refl_bit,
                jnp.where(miss, CODE_MISS, CODE_DEAD))
            ndx_ref[dep, :] = jnp.where(hit_live, sx, 0.0)
            ndy_ref[dep, :] = jnp.where(hit_live, sy, 0.0)
            ndz_ref[dep, :] = jnp.where(hit_live, sz, 0.0)
        thr_r = jnp.where(hit_live & ~is_die, thr_r * har, thr_r)
        thr_g = jnp.where(hit_live & ~is_die, thr_g * hag, thr_g)
        thr_b = jnp.where(hit_live & ~is_die, thr_b * hab, thr_b)
        return (
            jnp.where(hit_live, px, ox), jnp.where(hit_live, py, oy),
            jnp.where(hit_live, pz, oz), jnp.where(hit_live, sx, dx),
            jnp.where(hit_live, sy, dy), jnp.where(hit_live, sz, dz),
            thr_r, thr_g, thr_b, rad_r, rad_g, rad_b, hit_live & scattered,
        ) + miss_c

    carry = (ox, oy, oz, dx, dy, dz, ones, ones, ones, zeros, zeros, zeros,
             jnp.ones(shape, jnp.bool_)) + (zeros,) * n_miss

    # Per-block early exit: the loop ends at the depth where the block's
    # last ray terminated. (Triton has no `any` reduction; max of 0/1 is it.)
    def depth_cond(c):
        return (c[0] < max_depth) & (jnp.max(c[13].astype(jnp.int32)) > 0)

    def depth_body(c):
        return (c[0] + 1, *bounce(c[0], c[1:]))

    d_end, *carry = jax.lax.while_loop(depth_cond, depth_body, (jnp.int32(0), *carry))

    if record:
        # rows past the block's last live bounce are DEAD
        def dead_fill(d, x):
            res_refs[0][d, :] = jnp.full(shape, CODE_DEAD, jnp.int32)
            for r in res_refs[1:]:
                r[d, :] = zeros
            return x

        jax.lax.fori_loop(d_end, max_depth, dead_fill, 0)

    for ref, val in zip(rad_refs, carry[9:12]):
        ref[...] = val
    if record_miss:
        for ref, val in zip(miss_refs, carry[13:19]):
            ref[...] = val


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _pad_flat(x, total):
    """Pad a [R] plane to `total` by repeating its first element (padding
    rays re-trace ray 0 and are dropped)."""
    pad = total - x.shape[0]
    x = x.astype(jnp.float32)
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.broadcast_to(x[:1], (pad,))])


def _scene_table(scene: Scene) -> jnp.ndarray:
    """[N_ROWS, N_pad] float32 sphere table, N padded to a power of two with
    zero columns (radius 0). The kernel's loop stops at the real N, so the
    padding is never read."""
    rows = [
        scene.center0[:, 0], scene.center0[:, 1], scene.center0[:, 2],
        scene.center_delta[:, 0], scene.center_delta[:, 1], scene.center_delta[:, 2],
        scene.radius, scene.mat_type.astype(jnp.float32),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.fuzz, scene.ior,
    ]
    n = scene.radius.shape[0]
    sph = jnp.stack([r.astype(jnp.float32) for r in rows])
    return jnp.pad(sph, ((0, N_ROWS - len(rows)), (0, _next_pow2(n) - n)))


def _call(origin, direction, time, scene, seed, *, max_depth, t_min, block,
          interpret, inject_bug=None, record_miss=False, record=False):
    """Pad the rays to whole blocks, run the kernel, return its raw output
    planes (radiance [r_pad] x3, then miss or residual planes)."""
    _check_backend(interpret)
    if block & (block - 1) or block < 16:
        raise ValueError(f"block must be a power of two >= 16, got {block}")
    R = origin.shape[0]
    n = scene.radius.shape[0]
    r_pad = pl.cdiv(R, block) * block
    grid = r_pad // block
    planes = [
        _pad_flat(origin[:, 0], r_pad), _pad_flat(origin[:, 1], r_pad),
        _pad_flat(origin[:, 2], r_pad), _pad_flat(direction[:, 0], r_pad),
        _pad_flat(direction[:, 1], r_pad), _pad_flat(direction[:, 2], r_pad),
        _pad_flat(time, r_pad),
    ]
    table = _scene_table(scene)

    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    out_specs = [ray_spec] * 3
    out_shape = [jax.ShapeDtypeStruct((r_pad,), jnp.float32)] * 3
    if record_miss:
        out_specs += [ray_spec] * 6
        out_shape += [jax.ShapeDtypeStruct((r_pad,), jnp.float32)] * 6
    if record:
        d_pad = _next_pow2(max_depth)
        res_spec = pl.BlockSpec((d_pad, block), lambda i: (0, i))
        out_specs += [res_spec] * 4
        out_shape += [jax.ShapeDtypeStruct((d_pad, r_pad), jnp.int32)] + [
            jax.ShapeDtypeStruct((d_pad, r_pad), jnp.float32)] * 3

    kernel = functools.partial(
        _megakernel, n_spheres=n, max_depth=max_depth, t_min=t_min,
        block=block, inject_bug=inject_bug, record_miss=record_miss,
        record=record,
    )
    return pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,)),
                  pl.BlockSpec(table.shape, lambda i: (0, 0))] + [ray_spec] * 7,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(1, min(8, block // 32)), num_stages=1),
        interpret=interpret,
        name="rt_megakernel_record" if record else "rt_megakernel",
    )(jnp.asarray(seed, jnp.int32).reshape(1), table, *planes)


def _stack3(planes, R):
    return jnp.stack([p[:R] for p in planes], axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("max_depth", "t_min", "interpret", "inject_bug",
                     "record_miss", "block"),
)
def pallas_trace_paths(
    origin: jnp.ndarray,     # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    time: jnp.ndarray,       # [R]
    scene: Scene,
    seed: jnp.ndarray,       # scalar int32
    max_depth: int,
    t_min: float = T_MIN,
    interpret: bool = False,
    inject_bug: str | None = None,  # fault injection (tests only)
    record_miss: bool = False,
    block: int = BLOCK,
):
    """Radiance [R, 3] for camera rays — the full path trace in one kernel.

    With `record_miss=True` the kernel does not add the built-in sky
    gradient; it returns (radiance, miss_dir [R, 3], miss_thr [R, 3]), the
    ray direction and path throughput at the (unique) miss event, zeros for
    paths that never missed. The caller adds `miss_thr * sky(miss_dir)`.

    `interpret=True` runs Pallas's interpreter (any backend); otherwise the
    default backend must be the GPU."""
    R = origin.shape[0]
    outs = _call(origin, direction, time, scene, seed, max_depth=max_depth,
                 t_min=t_min, block=block, interpret=interpret,
                 inject_bug=inject_bug, record_miss=record_miss)
    rad = _stack3(outs[:3], R)
    if record_miss:
        return rad, _stack3(outs[3:6], R), _stack3(outs[6:9], R)
    return rad


def _decode_res(code):
    """(idx, refl) from a residual code plane: code = 2 * idx + refl, with
    idx >= 0 hit, -1 miss, -2 dead. The arithmetic shift floors, so the
    negative codes decode to themselves."""
    return code >> 1, (code & 1) == 1


@functools.partial(
    jax.jit, static_argnames=("max_depth", "t_min", "interpret", "block")
)
def pallas_trace_record(
    origin: jnp.ndarray,     # [R, 3]
    direction: jnp.ndarray,  # [R, 3]
    time: jnp.ndarray,       # [R]
    scene: Scene,
    seed: jnp.ndarray,       # scalar int32
    max_depth: int,
    t_min: float = T_MIN,
    interpret: bool = False,
    block: int = BLOCK,
):
    """pallas_trace_paths that also records the path residuals in-kernel,
    for the path-replay backward (grad/replay.py).

    Returns (radiance [R, 3], grad.replay.PathResiduals) — idx [D, R] int32
    (>= 0 hit sphere, -1 miss, -2 dead), ndir [D, R, 3], refl [D, R] bool.
    Same seed, same radiance as pallas_trace_paths."""
    from raytracingproject_tpu.grad.replay import PathResiduals

    R = origin.shape[0]
    outs = _call(origin, direction, time, scene, seed, max_depth=max_depth,
                 t_min=t_min, block=block, interpret=interpret, record=True)
    code, ndx, ndy, ndz = (x[:max_depth, :R] for x in outs[3:7])
    idx, refl = _decode_res(code)
    res = PathResiduals(idx=idx, ndir=jnp.stack([ndx, ndy, ndz], axis=-1),
                        refl=refl)
    return _stack3(outs[:3], R), res
