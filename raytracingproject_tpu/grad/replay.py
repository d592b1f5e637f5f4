"""Path-replay backpropagation: an O(depth) backward pass for path tracing.

The naive reverse-mode of the megakernel renderer re-intersects every sphere
per bounce in the backward sweep — O(N_spheres * depth) per ray both ways.
Path replay (the technique of Vicini et al. 2021, "Path Replay
Backpropagation") records the *discrete path decisions* during the forward
pass — which sphere was hit (or miss/dead), the sampled scatter direction,
and the dielectric reflect/refract branch — and differentiates a cheap
REPLAY of the path instead: per bounce, only the known hit sphere's
quadratic is re-solved (O(1), not O(N)), and the random scatter offsets are
reconstructed from the recorded direction as constants:

    lambertian  u  = stop_grad(dir_rec - n)          dir(p) = n(p) + u
    metal       f  = stop_grad((dir_rec - refl)/fz)  dir(p) = refl(p) + fz(p)*f
    dielectric  branch = recorded bit                dir(p) = reflect/refract(p)

This yields EXACTLY the same gradient estimator as reverse-mode through the
full XLA renderer (the RNG draws are parameter-independent and discrete
topology — winner argmin, branch masks, absorption — is piecewise-constant,
i.e. stop-gradient in both): test_replay.py asserts analytic equality. The
payoff: the forward can be the Pallas megakernel (which has no VJP) with
residuals recorded in-kernel, and the backward costs O(depth) per ray.

The reference has no differentiable rendering at all; this module is part
of the differentiable additions (SURVEY.md §7, build-plan
step 5). Known estimator properties (documented, matching grad/inverse.py):
- fuzz gradient at exactly fuzz == 0 is taken as 0 (the recorded direction
  carries no information about the fuzz sample there; fuzz >= 0 so the true
  derivative is one-sided anyway),
- discrete-event probabilities (Schlick branch, metal absorption) carry no
  score-function term — same estimator as the direct path.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracingproject_tpu.config import T_MIN, LAMBERTIAN, METAL, DIELECTRIC
from raytracingproject_tpu.grad.inverse import SceneParams, apply_params
from raytracingproject_tpu.materials import scatter
from raytracingproject_tpu.ops.intersect import closest_hit
from raytracingproject_tpu.ops.vecmath import dot, normalize, refract
from raytracingproject_tpu.render import sky_color
from raytracingproject_tpu.scene import Scene

# idx codes (per bounce): >= 0 hit that sphere; MISS = sky then retire;
# DEAD = ray already terminated (nothing happens).
MISS = -1
DEAD = -2


# The one-hot products below are gathers written as matrix products. They
# must be exact: at default precision a float32 product may run in TF32 on a
# GPU (about three decimal digits), and gathered centres and radii would no
# longer match the forward pass.
HIGHEST = jax.lax.Precision.HIGHEST


def _make_gather_rows(n: int, onehot_fwd: bool = False):
    """Row gather with a one-hot-matmul backward (see replay_radiance
    docstring). `n` is the table row count (static).

    Forward: jnp.take behind an optimization_barrier — without the barrier
    XLA hoists the loop-"invariant" gather out of the replay scan and
    materializes every bounce's attribute rows at once ([D, R, C], a
    compile-time out-of-memory at 1200x675 depth 50). `onehot_fwd=True`
    keeps the one-hot matmul forward instead (never hoistable, [R, n]
    working set per step)."""
    import numpy as np

    def _onehot(idx, dtype):
        return (
            idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]
        ).astype(dtype)

    @jax.custom_vjp
    def gather(table, idx):  # [n, C], [R] int32 -> [R, C]
        if onehot_fwd:
            return jnp.dot(_onehot(idx, table.dtype), table,
                           preferred_element_type=table.dtype,
                           precision=HIGHEST)
        return jnp.take(jax.lax.optimization_barrier(table), idx, axis=0)

    def fwd(table, idx):
        return gather(table, idx), idx

    def bwd(idx, g):
        g_table = jnp.einsum(
            "rn,rc->nc", _onehot(idx, g.dtype), g,
            preferred_element_type=g.dtype, precision=HIGHEST,
        )
        return g_table, np.zeros(idx.shape, jax.dtypes.float0)

    gather.defvjp(fwd, bwd)
    return gather


def _make_gather_cols(n: int):
    """Row gather with attrs in [C, R] (ray-minor) layout, both directions
    as one-hot matrix products: [C, n] x [n, R] forward and [C, R] x [R, n]
    for the table cotangent, so the large ray axis is the minor dimension.
    Exact: the same one-hot products as _make_gather_rows, relaid."""
    import numpy as np

    def _onehot_t(idx, dtype):  # [n, R]
        return (
            jnp.arange(n, dtype=idx.dtype)[:, None] == idx[None, :]
        ).astype(dtype)

    @jax.custom_vjp
    def gather(table_t, idx):  # [C, n], [R] int32 -> [C, R]
        return jnp.dot(table_t, _onehot_t(idx, table_t.dtype),
                       preferred_element_type=table_t.dtype,
                       precision=HIGHEST)

    def fwd(table_t, idx):
        return gather(table_t, idx), idx

    def bwd(idx, g):  # g [C, R] -> table_t cotangent [C, n]
        g_t = jnp.dot(g, jnp.transpose(_onehot_t(idx, g.dtype)),
                      preferred_element_type=g.dtype, precision=HIGHEST)
        return g_t, np.zeros(idx.shape, jax.dtypes.float0)

    gather.defvjp(fwd, bwd)
    return gather


class PathResiduals(NamedTuple):
    """Recorded path decisions; leading axis = bounce depth.

    All leaves are non-differentiable constants of the replay.
    """

    idx: jnp.ndarray    # [D, R] int32 — hit sphere / MISS / DEAD
    ndir: jnp.ndarray   # [D, R, 3] float — scattered direction (valid on hit)
    refl: jnp.ndarray   # [D, R] bool — dielectric reflect branch taken


def xla_trace_record(
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    time: jnp.ndarray,
    key: jax.Array,
    max_depth: int,
) -> tuple[jnp.ndarray, PathResiduals]:
    """Forward trace (identical radiance to render.ray_color with the same
    key) that also records PathResiduals. The equivalence tests' residual
    source; the GPU megakernel records the same structure in-kernel
    (megakernel.pallas_trace_record)."""
    n = origin.shape[0]
    dtype = origin.dtype

    def step(carry, depth):
        o, d, thr, L, alive = carry
        k = jax.random.fold_in(key, depth)
        rec = closest_hit(
            o, d, time, scene.center0, scene.center_delta, scene.radius, t_min=T_MIN
        )
        sc = scatter(k, d, rec, scene)

        miss = alive & ~rec.hit
        L = L + jnp.where(miss[:, None], thr * sky_color(d), 0.0)
        hit_live = alive & rec.hit
        thr = jnp.where(hit_live[:, None], thr * sc.attenuation, thr)
        alive_next = hit_live & sc.scattered

        idx = jnp.where(hit_live, rec.idx, jnp.where(miss, MISS, DEAD)).astype(jnp.int32)
        res = (idx, jnp.where(hit_live[:, None], sc.direction, 0.0),
               sc.dielectric_reflected & hit_live)

        o = jnp.where(hit_live[:, None], rec.p, o)
        d = jnp.where(hit_live[:, None], sc.direction, d)
        return (o, d, thr, L, alive_next), res

    init = (
        origin, direction,
        jnp.ones((n, 3), dtype), jnp.zeros((n, 3), dtype), jnp.ones((n,), bool),
    )
    (_, _, _, radiance, _), (idx, ndir, refl) = jax.lax.scan(
        step, init, jnp.arange(max_depth)
    )
    return radiance, PathResiduals(idx=idx, ndir=ndir, refl=refl)


def _attr_table(scene_p: Scene, scene: Scene) -> jnp.ndarray:
    """[N, 13] attribute table (differentiable leaves as columns)."""
    return jnp.concatenate(
        [
            scene_p.center0,                     # 0:3
            scene_p.center_delta,                # 3:6
            scene_p.radius[:, None],             # 6
            scene_p.albedo,                      # 7:10
            scene_p.fuzz[:, None],               # 10
            scene_p.ior[:, None],                # 11
            scene.mat_type.astype(jnp.float32)[:, None],  # 12 (non-diff)
        ],
        axis=1,
    )


def _make_live_step(table, gather_rows):
    """One differentiable replay bounce: carry (o, d, thr, L), residual row
    r = (idx, ndir, refl). See the module docstring for the replay algebra;
    the quadratic re-solve is src/sphere.h:30-57 on the known winner."""
    sg = jax.lax.stop_gradient

    def _live_step(time, carry, r):
        o, d, thr, L = carry
        idx, ndir, refl = r
        # DEGENERATE-DIRECTION GRADIENT GUARD: a lambertian scatter can
        # record ndir ~ 0 (u ~ -n — the case src/vec3.h's near_zero flags
        # and src/material.h:19-25 leaves unfixed; we reproduce the
        # reference estimator). The carry direction then goes ~0 and every
        # 1/|d|-flavored derivative turns near-singular — measured
        # NaN-poisoning whole training runs. Values are kept
        # EXACT; only the gradient through such a row's direction is
        # stopped (its true derivative is unbounded there anyway).
        sgx = jax.lax.stop_gradient
        d_ok = (jnp.sum(d * d, axis=-1) > 1e-12)[:, None]
        d = jnp.where(d_ok, d, sgx(d))
        hit = idx >= 0
        miss = idx == MISS
        i = jnp.maximum(idx, 0)

        attrs = gather_rows(table, i)
        c0 = attrs[:, 0:3]
        cd = attrs[:, 3:6]
        rad = attrs[:, 6]
        alb = attrs[:, 7:10]
        fz = attrs[:, 10]
        ior = attrs[:, 11]
        mat = attrs[:, 12].astype(jnp.int32)

        # re-solve the winner's quadratic (src/sphere.h:30-57): the final
        # closest root is r0 when r0 > t_min else r1 (r0 <= r1 always).
        cc = c0 + time[:, None] * cd
        oc = o - cc
        a = jnp.maximum(dot(d, d), 1e-20)
        hb = dot(oc, d)
        cq = dot(oc, oc) - rad * rad
        disc = hb * hb - a * cq
        dpos = disc > 0.0
        sq = jnp.sqrt(jnp.where(dpos, disc, 1.0))
        r0 = (-hb - sq) / a
        r1 = (-hb + sq) / a
        t = jnp.where(r0 > T_MIN, r0, r1)
        t = jnp.where(hit, t, 1.0)

        p = o + t[:, None] * d
        r_safe = jnp.where(rad != 0.0, rad, 1.0)
        outward = (p - cc) / r_safe[:, None]
        front = dot(d, outward) < 0.0
        nrm = jnp.where(front[:, None], outward, -outward)

        L = L + jnp.where(miss[:, None], thr * sky_color(d), 0.0)
        att = jnp.where((mat == DIELECTRIC)[:, None], 1.0, alb)
        thr = jnp.where(hit[:, None], thr * att, thr)

        # Grad-safe unit direction: normalize()'s sqrt differentiates to
        # inf at |d| == 0, and a degenerate lambertian scatter (u ~ -n,
        # the case src/vec3.h's near_zero flags) records ndir ~ 0 — the
        # unguarded form NaN-poisoned geometry gradients; the
        # maximum routes the zero-length branch's gradient to the
        # constant, i.e. zero.
        ud = d * jax.lax.rsqrt(jnp.maximum(dot(d, d), 1e-24))[:, None]
        # lambertian: recorded dir = n + u, u parameter-independent
        u_const = sg(ndir) - sg(nrm)
        lam_dir = nrm + u_const

        # metal: recorded dir = reflect + fuzz * f
        rfl = ud - 2.0 * dot(ud, nrm)[:, None] * nrm
        fz_obs = sg(fz)
        f_const = jnp.where(
            (fz_obs > 1e-6)[:, None],
            (sg(ndir) - sg(rfl)) / jnp.maximum(fz_obs, 1e-6)[:, None],
            0.0,
        )
        met_dir = rfl + fz[:, None] * f_const

        # dielectric: recorded branch bit
        ratio = jnp.where(front, 1.0 / ior, ior)
        die_dir = jnp.where(refl[:, None], rfl, refract(ud, nrm, ratio))

        nd = jnp.where(
            (mat == LAMBERTIAN)[:, None],
            lam_dir,
            jnp.where((mat == METAL)[:, None], met_dir, die_dir),
        )
        o = jnp.where(hit[:, None], p, o)
        d = jnp.where(hit[:, None], nd, d)
        return (o, d, thr, L)

    return _live_step


def _make_live_step_cols(table_t, gather_cols):
    """_make_live_step with the [C, R] (ray-minor) attribute gather: the
    same replay bounce written COMPONENT-WISE so every intermediate is an
    [R] vector and the gathered attribute rows are consumed directly —
    no [R, C] relayout anywhere. Carry stays (o, d, thr, L) in [R, 3]
    (split/stacked per step; fused elementwise)."""
    sg = jax.lax.stop_gradient

    def _live_step(time, carry, r):
        o, d, thr, L = carry
        idx, ndir, refl = r
        ndx, ndy, ndz = ndir[:, 0], ndir[:, 1], ndir[:, 2]
        # degenerate-direction gradient guard — see _make_live_step
        d_ok = (jnp.sum(d * d, axis=-1) > 1e-12)[:, None]
        d = jnp.where(d_ok, d, sg(d))
        hit = idx >= 0
        miss = idx == MISS
        i = jnp.maximum(idx, 0)

        A = gather_cols(table_t, i)  # [13, R]
        c0x, c0y, c0z = A[0], A[1], A[2]
        cdx, cdy, cdz = A[3], A[4], A[5]
        rad = A[6]
        alr, alg, alb = A[7], A[8], A[9]
        fz = A[10]
        ior = A[11]
        mat = A[12].astype(jnp.int32)

        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]

        ccx = c0x + time * cdx
        ccy = c0y + time * cdy
        ccz = c0z + time * cdz
        ocx = ox - ccx; ocy = oy - ccy; ocz = oz - ccz
        a = jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-20)
        hb = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        disc = hb * hb - a * cq
        dpos = disc > 0.0
        sq = jnp.sqrt(jnp.where(dpos, disc, 1.0))
        r0 = (-hb - sq) / a
        r1 = (-hb + sq) / a
        t = jnp.where(r0 > T_MIN, r0, r1)
        t = jnp.where(hit, t, 1.0)

        px = ox + t * dx; py = oy + t * dy; pz = oz + t * dz
        r_safe = jnp.where(rad != 0.0, rad, 1.0)
        owx = (px - ccx) / r_safe
        owy = (py - ccy) / r_safe
        owz = (pz - ccz) / r_safe
        front = dx * owx + dy * owy + dz * owz < 0.0
        sgn = jnp.where(front, 1.0, -1.0)
        nx = owx * sgn; ny = owy * sgn; nz = owz * sgn

        sky = sky_color(d)
        m = miss.astype(thr.dtype)
        L = L + (m[:, None] * thr) * sky
        is_die = mat == DIELECTRIC
        h = hit.astype(thr.dtype)[:, None]
        att = jnp.stack([
            jnp.where(is_die, 1.0, alr), jnp.where(is_die, 1.0, alg),
            jnp.where(is_die, 1.0, alb),
        ], axis=-1)
        thr = thr * (1.0 - h) + thr * att * h

        inv_len = jax.lax.rsqrt(a)
        udx = dx * inv_len; udy = dy * inv_len; udz = dz * inv_len

        # lambertian: recorded dir = n + u, u parameter-independent
        lamx = nx + (sg(ndx) - sg(nx))
        lamy = ny + (sg(ndy) - sg(ny))
        lamz = nz + (sg(ndz) - sg(nz))

        # metal: recorded dir = reflect + fuzz * f
        udn = udx * nx + udy * ny + udz * nz
        rflx = udx - 2.0 * udn * nx
        rfly = udy - 2.0 * udn * ny
        rflz = udz - 2.0 * udn * nz
        fz_obs = sg(fz)
        fdiv = jnp.maximum(fz_obs, 1e-6)
        fmask = (fz_obs > 1e-6).astype(fz.dtype)
        fcx = fmask * (sg(ndx) - sg(rflx)) / fdiv
        fcy = fmask * (sg(ndy) - sg(rfly)) / fdiv
        fcz = fmask * (sg(ndz) - sg(rflz)) / fdiv
        metx = rflx + fz * fcx
        mety = rfly + fz * fcy
        metz = rflz + fz * fcz

        # dielectric: recorded branch bit
        ratio = jnp.where(front, 1.0 / ior, ior)
        cos_t = jnp.minimum(-(udx * nx + udy * ny + udz * nz), 1.0)
        perpx = ratio * (udx + cos_t * nx)
        perpy = ratio * (udy + cos_t * ny)
        perpz = ratio * (udz + cos_t * nz)
        # grad-safe sqrt (the double-where of ops/vecmath.refract): the
        # derivative of sqrt at 0 is inf, and near-TIR rays reach k == 0 —
        # an unguarded sqrt here NaN-poisons training runs
        k = jnp.abs(1.0 - (perpx * perpx + perpy * perpy + perpz * perpz))
        k_pos = k > 0.0
        spar = -jnp.where(k_pos, jnp.sqrt(jnp.where(k_pos, k, 1.0)), 0.0)
        diex = jnp.where(refl, rflx, perpx + spar * nx)
        diey = jnp.where(refl, rfly, perpy + spar * ny)
        diez = jnp.where(refl, rflz, perpz + spar * nz)

        is_lam = mat == LAMBERTIAN
        is_met = mat == METAL
        ndx_o = jnp.where(is_lam, lamx, jnp.where(is_met, metx, diex))
        ndy_o = jnp.where(is_lam, lamy, jnp.where(is_met, mety, diey))
        ndz_o = jnp.where(is_lam, lamz, jnp.where(is_met, metz, diez))

        hitf = hit.astype(o.dtype)
        o = jnp.stack([
            ox + hitf * (px - ox), oy + hitf * (py - oy),
            oz + hitf * (pz - oz),
        ], axis=-1)
        d = jnp.stack([
            dx + hitf * (ndx_o - dx), dy + hitf * (ndy_o - dy),
            dz + hitf * (ndz_o - dz),
        ], axis=-1)
        return (o, d, thr, L)

    return _live_step


def replay_radiance(
    params: SceneParams,
    scene: Scene,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    time: jnp.ndarray,
    res: PathResiduals,
    n_groups: int = 1,
    skip_dead: bool | None = None,
    gather: str | None = None,
) -> jnp.ndarray:
    """Differentiable replay of recorded paths: radiance [R, 3] as a
    function of `params`, with all discrete decisions frozen to `res`.

    At the recording parameters this reproduces the forward radiance to
    float precision; its jax.grad equals reverse-mode through the full
    renderer (see module docstring). Cost per bounce: ONE sphere quadratic
    per ray.

    Attribute lookup is a hybrid gather: plain jnp.take in the forward with
    a custom VJP that transposes as a one-hot matrix product
    (onehot^T @ cotangent) instead of jnp.take's default scatter-add
    transpose. For deep recordings (depth > 16) the forward is a one-hot
    product too (`_make_gather_rows(onehot_fwd=True)`). Exact: the one-hot
    rows have a single 1.0, and every product runs at HIGHEST precision, so
    the products reproduce the gather and its adjoint.

    DEAD-DEPTH SKIPPING: each scan step is predicated on "any ray in this
    batch still un-dead at this bounce" (a constant of `res`), so bounces
    past the batch's deepest path cost one skipped cond in both sweeps —
    at the reference's depth 50 (src/main.cpp:59) typical paths die in
    2-4 bounces and the whole [D] scan is priced by the deepest survivor,
    not by max_depth. `n_groups > 1` extends this sub-batch: rays are
    sorted by death depth (a stop-gradient permutation — parameter
    gradients are permutation-invariant sums, and the returned radiance is
    unpermuted), split into `n_groups` equal slices, and each slice scans
    only while ITS deepest ray lives; the shallow majority stops early
    instead of riding the one depth-50 glass path. Exactness-preserving:
    a skipped bounce is identity for every ray in the slice (dead rays
    update nothing), and death is permanent so the predicate is monotone."""
    scene_p = apply_params(scene, params)
    n_spheres = scene.radius.shape[0]
    # Gather mode: take forward for shallow recordings, one-hot forward for
    # deep ones (it also rules out the hoisted [D, R, C] gather). `gather`
    # override: "colT" = the ray-minor one-hot gather (_make_gather_cols).
    # The GPU cost of each mode is not measured yet.
    table = _attr_table(scene_p, scene)
    if gather == "colT":
        _live_step = _make_live_step_cols(
            jnp.transpose(table), _make_gather_cols(n_spheres)
        )
    else:
        gather_rows = _make_gather_rows(
            n_spheres, onehot_fwd=res.idx.shape[0] > 16
        )
        _live_step = _make_live_step(table, gather_rows)

    def step(tm, carry, r):
        pred, rr = r
        return (
            jax.lax.cond(
                pred, lambda c, x: _live_step(tm, c, x), lambda c, _: c,
                carry, rr,
            ),
            None,
        )

    sgi = jax.lax.stop_gradient

    def run_scan(o0, d0, tm, idx, ndir, refl, use_cond=True):
        """One replay scan over a ray slice; `use_cond` predicates each
        step on "any ray in this slice un-dead at this bounce"."""
        from functools import partial

        n = o0.shape[0]
        dtype = o0.dtype
        init = (o0, d0, jnp.ones((n, 3), dtype), jnp.zeros((n, 3), dtype))
        # Rematerialize the bounce body in the backward sweep: without this
        # the scan saves each bounce's [R, N] one-hot (and quadratic
        # intermediates) to device memory as residuals, dominating the step. Recomputing them from the [R] carry + idx
        # costs one cheap quadratic per ray (the whole point of replay) and
        # collapses residual traffic to the scan carries.
        if use_cond:
            # pred is a constant of the residuals; once false it stays
            # false (death is permanent)
            pred = sgi(jnp.any(idx != DEAD, axis=1))  # [D]
            (_, _, _, L), _ = jax.lax.scan(
                jax.checkpoint(partial(step, tm)), init,
                (pred, (idx, ndir, refl)),
            )
        else:
            body = lambda c, r: (_live_step(tm, c, r), None)
            (_, _, _, L), _ = jax.lax.scan(
                jax.checkpoint(body), init, (idx, ndir, refl)
            )
        return L

    # skip_dead default: off for one group (a cond-wrapped step compiles to
    # a slower scan than the straight-line one); grouping defaults its
    # slices to cond, since skipping per slice is its whole point.
    if skip_dead is None:
        skip_dead = n_groups > 1

    if n_groups <= 1:
        return run_scan(origin, direction, time,
                        res.idx, res.ndir, res.refl, use_cond=skip_dead)

    R = origin.shape[0]
    # death depth per ray (idx != DEAD is a prefix property: death is
    # permanent); descending sort so slice 0 holds the deepest paths
    depth_of = jnp.sum((res.idx != DEAD).astype(jnp.int32), axis=0)  # [R]
    perm = sgi(jnp.argsort(-depth_of))
    pad = (-R) % n_groups
    if pad:
        # padding slots replay all-DEAD copies of ray 0: zero radiance,
        # every bounce skippable — appended after the sort so they land in
        # the shallow tail slice and are dropped before the unpermute
        perm_x = jnp.concatenate([perm, jnp.zeros((pad,), perm.dtype)])
        dead_col = jnp.full((res.idx.shape[0], pad), DEAD, res.idx.dtype)
        idx_s = jnp.concatenate([res.idx[:, perm], dead_col], axis=1)
    else:
        perm_x = perm
        idx_s = res.idx[:, perm]
    o_s = jnp.take(origin, perm_x, axis=0)
    d_s = jnp.take(direction, perm_x, axis=0)
    t_s = jnp.take(time, perm_x)
    nd_s = jnp.take(res.ndir, perm_x, axis=1)
    rf_s = jnp.take(res.refl, perm_x, axis=1)
    g = (R + pad) // n_groups
    Ls = [
        run_scan(
            o_s[k * g : (k + 1) * g], d_s[k * g : (k + 1) * g],
            t_s[k * g : (k + 1) * g], idx_s[:, k * g : (k + 1) * g],
            nd_s[:, k * g : (k + 1) * g], rf_s[:, k * g : (k + 1) * g],
            use_cond=skip_dead,
        )
        for k in range(n_groups)
    ]
    L_sorted = jnp.concatenate(Ls, axis=0)[:R]  # drop padding slots
    inv = sgi(jnp.argsort(perm))                # unpermute
    return jnp.take(L_sorted, inv, axis=0)
