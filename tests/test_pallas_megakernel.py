"""GPU megakernel (Pallas, Triton route) against the XLA renderer, run in
Pallas's interpreter on the CPU: exact where a path consumes no randomness,
statistical elsewhere (different RNG streams, same distributions); its
counter-based RNG, padding, block-size invariance, residual encoding, and
the rule that it runs compiled on the GPU or interpreted on request only.

Every interpreted case stays within two blocks of rays and depth <= 4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.camera import Camera, generate_rays
from raytracingproject_tpu.ops.pallas import megakernel as mk
from raytracingproject_tpu.ops.pallas.megakernel import (
    pallas_trace_paths, pallas_trace_record,
)
from raytracingproject_tpu.render import ray_color
from raytracingproject_tpu.scene import (
    make_cover_scene, make_minimal_scene, make_three_sphere_scene,
)
from raytracingproject_tpu.validation import Z_MAX, material_labels, region_z_scores

CAM3 = dict(
    aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1,
    max_depth=8, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
    lookat=(0.0, 0.0, -1.0), defocus_angle=0.0, focus_dist=1.0,
)
CAM_COVER = dict(
    aspect_ratio=16.0 / 9.0, image_width=96, samples_per_pixel=1,
    max_depth=8, vfov=20.0, lookfrom=(13.0, 2.0, 3.0),
    lookat=(0.0, 0.0, 0.0), defocus_angle=0.6, focus_dist=10.0,
)


def gen(cam, n_rays, key):
    d = cam.derive()
    w, h = cam.image_size()
    idx = jax.random.randint(key, (n_rays,), 0, w * h)
    i = (idx % w).astype(jnp.int32)
    j = (idx // w).astype(jnp.int32)
    return generate_rays(d, i, j, jax.random.fold_in(key, 1))


def test_megakernel_depth1_exact():
    """Depth-1 paths are RNG-free (primary hit -> throughput stops, or sky):
    the megakernel and the XLA renderer must agree to float tolerance per
    ray."""
    scene = make_three_sphere_scene()
    o, d, t = gen(Camera(**CAM3), 4096, jax.random.PRNGKey(0))
    pk = np.asarray(pallas_trace_paths(o, d, t, scene, jnp.int32(7),
                                       max_depth=1, interpret=True, block=2048))
    xk = np.asarray(ray_color(scene, o, d, t, jax.random.PRNGKey(3), max_depth=1))
    assert np.isfinite(pk).all()
    np.testing.assert_allclose(pk, xk, atol=5e-5)


def test_megakernel_sky_exact():
    """Rays that miss everything: the sky gradient is deterministic and must
    match the XLA path exactly (no RNG involvement)."""
    scene = make_minimal_scene()
    scene = scene._replace(center0=scene.center0 + 1e6)  # park spheres away
    R = 2048
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(-1, 1, (R, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32))
    t = jnp.asarray(rng.random(R).astype(np.float32))
    pk = np.asarray(pallas_trace_paths(o, d, t, scene, jnp.int32(1),
                                       max_depth=4, interpret=True, block=1024))
    xk = np.asarray(ray_color(scene, o, d, t, jax.random.PRNGKey(1), max_depth=4))
    np.testing.assert_allclose(pk, xk, atol=2e-5)


def test_megakernel_deterministic_given_seed():
    scene = make_three_sphere_scene()
    R = 1024
    rng = np.random.default_rng(2)
    o = jnp.asarray(rng.uniform(-2, 2, (R, 3)).astype(np.float32))
    d = jnp.asarray(rng.normal(size=(R, 3)).astype(np.float32))
    t = jnp.asarray(rng.random(R).astype(np.float32))
    run = lambda s: np.asarray(pallas_trace_paths(
        o, d, t, scene, jnp.int32(s), max_depth=4, interpret=True, block=512))
    a, b = run(5), run(5)
    np.testing.assert_array_equal(a, b)
    # the RNG really fires: bounce paths vary with the seed
    assert not np.array_equal(a, run(6))


def test_megakernel_record_miss_identity():
    """record_miss=True must be a pure refactor of the sky accumulation:
    radiance + miss_thr * default_sky(miss_dir) == the plain kernel's
    radiance (same seed -> same random stream -> identical paths). This is
    the exactness contract env-map lighting rides on (render_pass applies
    the texture lookup to the recorded planes)."""
    from raytracingproject_tpu.render import sky_color

    scene = make_three_sphere_scene()
    o, d, t = gen(Camera(**CAM3), 4096, jax.random.PRNGKey(5))
    kw = dict(max_depth=4, interpret=True, block=2048)
    plain = np.asarray(pallas_trace_paths(o, d, t, scene, jnp.int32(11), **kw))
    rad, mdir, mthr = pallas_trace_paths(o, d, t, scene, jnp.int32(11),
                                         record_miss=True, **kw)
    rad, mdir, mthr = np.asarray(rad), np.asarray(mdir), np.asarray(mthr)
    assert np.isfinite(rad).all() and np.isfinite(mdir).all()
    total = rad + mthr * np.asarray(sky_color(jnp.asarray(mdir)))
    np.testing.assert_allclose(total, plain, atol=2e-5)
    # never-missed paths leave their planes at exactly zero
    never = (np.abs(mdir).sum(axis=-1) == 0.0)
    assert (mthr[never] == 0.0).all()


# ---------------------------------------------------------------------------
# Counter-based RNG
# ---------------------------------------------------------------------------

def _stream(vary: str, n: int = 1 << 16):
    """[n, 4] draws with one of (seed, ray, bounce) running over n values
    and the others fixed."""
    k = jnp.arange(n, dtype=jnp.uint32)
    seed, ray, bounce = jnp.uint32(12345), jnp.full((n,), 77, jnp.uint32), 3
    if vary == "seed":
        out = jax.vmap(lambda s: jnp.stack(mk.draws(s, ray[:1], bounce))[:, 0])(k)
        return np.asarray(out)
    if vary == "ray":
        return np.asarray(jnp.stack(mk.draws(seed, k, bounce), axis=-1))
    out = jax.vmap(lambda b: jnp.stack(mk.draws(seed, ray[:1], b))[:, 0])(k)
    return np.asarray(out)


@pytest.mark.parametrize("vary", ["seed", "ray", "bounce"])
def test_rng_uniform_in_range(vary):
    """Each draw slot is U[0, 1): in range, 24-bit grid, and a chi-square
    over 64 bins within its 1e-6 tail (df 63: 130)."""
    u = _stream(vary)
    assert (u >= 0.0).all() and (u < 1.0).all()
    np.testing.assert_array_equal(u * (1 << 24), np.floor(u * (1 << 24)))
    n = u.shape[0]
    for slot in range(4):
        counts = np.histogram(u[:, slot], bins=64, range=(0.0, 1.0))[0]
        chi2 = ((counts - n / 64) ** 2 / (n / 64)).sum()
        assert chi2 < 130.0, (vary, slot, chi2)


@pytest.mark.parametrize("vary", ["seed", "ray", "bounce"])
def test_rng_draws_independent(vary):
    """No linear dependence between the four draw slots, nor between
    neighbouring counters: |correlation| < 5 / sqrt(n)."""
    u = _stream(vary)
    n = u.shape[0]
    bound = 5.0 / np.sqrt(n)
    c = np.corrcoef(u.T)
    off = c[~np.eye(4, dtype=bool)]
    assert np.abs(off).max() < bound, c
    for slot in range(4):
        lag = np.corrcoef(u[:-1, slot], u[1:, slot])[0, 1]
        assert abs(lag) < bound, (slot, lag)


def test_rng_streams_distinct_across_inputs():
    """Changing any one input word changes the draws (no two of seed, ray,
    bounce alias each other)."""
    base = np.asarray(jnp.stack(mk.draws(1, jnp.arange(4096, dtype=jnp.uint32), 2)))
    for seed, bounce in [(2, 2), (1, 3)]:
        other = np.asarray(jnp.stack(
            mk.draws(seed, jnp.arange(4096, dtype=jnp.uint32), bounce)))
        assert (other != base).mean() > 0.99
    swapped = np.asarray(jnp.stack(mk.draws(2, jnp.arange(4096, dtype=jnp.uint32), 1)))
    assert (swapped != base).mean() > 0.99


# ---------------------------------------------------------------------------
# Blocks and padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 128, 256])
def test_block_size_invariance(block):
    """The random stream is keyed by the global ray index, so the image does
    not depend on the block size: bitwise equal to 32-ray blocks."""
    scene = make_three_sphere_scene()
    o, d, t = gen(Camera(**CAM3), 64, jax.random.PRNGKey(12))
    kw = dict(max_depth=4, interpret=True)
    ref = np.asarray(pallas_trace_paths(o, d, t, scene, jnp.int32(9), block=32, **kw))
    got = np.asarray(pallas_trace_paths(o, d, t, scene, jnp.int32(9), block=block, **kw))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_rays", [1, 127, 1000, 4097])
def test_padding(n_rays):
    """Any ray count: outputs have the caller's shape, and padding rays
    (copies of ray 0) never change a real ray — two blocks with one amount
    of padding give the same radiance and residuals as one block with
    another."""
    scene = make_three_sphere_scene()
    o, d, t = gen(Camera(**CAM3), n_rays, jax.random.PRNGKey(n_rays))
    one = max(16, mk._next_pow2(n_rays))
    two = max(16, mk._next_pow2(-(-n_rays // 2)))
    kw = dict(max_depth=2, interpret=True)
    a = pallas_trace_paths(o, d, t, scene, jnp.int32(4), block=one, **kw)
    rad, res = pallas_trace_record(o, d, t, scene, jnp.int32(4), block=two, **kw)
    assert a.shape == rad.shape == (n_rays, 3)
    assert res.idx.shape == res.refl.shape == (2, n_rays)
    assert res.ndir.shape == (2, n_rays, 3)
    np.testing.assert_array_equal(np.asarray(rad), np.asarray(a))


def test_block_must_be_power_of_two():
    scene = make_minimal_scene()
    o = jnp.zeros((8, 3))
    with pytest.raises(ValueError, match="power of two"):
        pallas_trace_paths(o, o + 1.0, o[:, 0], scene, jnp.int32(0), 2,
                           interpret=True, block=96)


@pytest.mark.parametrize("idx,refl", [(-2, False), (-1, False), (0, False),
                                      (0, True), (486, True), (1 << 20, False)])
def test_decode_res_round_trip(idx, refl):
    """The residual code 2 * idx + refl_bit (refl only on hits) decodes back
    to (idx, refl); the arithmetic shift floors the negative codes."""
    code = jnp.asarray([2 * idx + int(refl)], jnp.int32)
    got_idx, got_refl = mk._decode_res(code)
    assert int(got_idx[0]) == idx and bool(got_refl[0]) == refl


# ---------------------------------------------------------------------------
# Statistics against the XLA renderer
# ---------------------------------------------------------------------------

SCENES = {
    "minimal": (make_minimal_scene, CAM3),
    "three": (make_three_sphere_scene, CAM3),
    "cover": (lambda: make_cover_scene(seed=0), CAM_COVER),
}


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_megakernel_matches_xla_statistics(scene_name, depth):
    """Per-sample radiance of the same camera rays, megakernel vs
    render.ray_color: every material region's mean within Z_MAX standard
    errors (validation.py, shared with the GPU lane and chip_smoke.py)."""
    scene_fn, cam_kw = SCENES[scene_name]
    scene = scene_fn()
    o, d, t = gen(Camera(**cam_kw), 8192, jax.random.PRNGKey(depth))
    pk = pallas_trace_paths(o, d, t, scene, jnp.int32(13), depth,
                            interpret=True, block=4096)
    xk = ray_color(scene, o, d, t, jax.random.PRNGKey(14), depth)
    z = region_z_scores(pk, xk, material_labels(scene, o, d, t), min_count=500)
    assert max(z.values()) < Z_MAX, z


@pytest.fixture(scope="module")
def glass_rays():
    """65536 camera rays of the three-sphere scene, most of them on the
    dielectric sphere, and their region labels."""
    scene = make_three_sphere_scene()
    cam = Camera(aspect_ratio=1.0, image_width=128, samples_per_pixel=1,
                 max_depth=4, vfov=40.0, lookfrom=(0.0, 0.0, 0.0),
                 lookat=(-1.0, 0.0, -1.0))
    o, d, t = gen(cam, 1 << 16, jax.random.PRNGKey(21))
    return scene, (o, d, t), material_labels(scene, o, d, t)


@pytest.mark.parametrize("inject_bug", [None, "schlick3"])
def test_region_statistics_detect_injected_bug(glass_rays, inject_bug):
    """The statistical test passes the megakernel and fails it with a wrong
    Schlick exponent (inject_bug='schlick3'): a test that cannot detect a
    planted bug proves nothing."""
    scene, (o, d, t), labels = glass_rays
    pk = pallas_trace_paths(o, d, t, scene, jnp.int32(21), 4, interpret=True,
                            block=1 << 15, inject_bug=inject_bug)
    xk = ray_color(scene, o, d, t, jax.random.PRNGKey(22), 4)
    z = region_z_scores(pk, xk, labels)
    if inject_bug is None:
        assert max(z.values()) < Z_MAX, z
    else:
        assert z["dielectric"] > Z_MAX, z


# ---------------------------------------------------------------------------
# Compiled for the GPU, or interpreted on request
# ---------------------------------------------------------------------------

def _entry_points():
    """Callables that reach the kernel without asking for the interpreter."""
    from raytracingproject_tpu.grad.fast import make_fast_radiance
    from raytracingproject_tpu.grad.inverse import extract_params
    from raytracingproject_tpu.parallel import (
        make_mesh, make_sharded_train_step, render_sharded,
    )
    from raytracingproject_tpu.render import render_pass

    scene = make_three_sphere_scene()
    cam = Camera(aspect_ratio=1.0, image_width=8, samples_per_pixel=2,
                 max_depth=2, vfov=60.0)
    o = jnp.zeros((8, 3))
    mesh = make_mesh(jax.devices()[:2])
    return {
        "trace_paths": lambda: pallas_trace_paths(
            o, o + 1.0, o[:, 0], scene, jnp.int32(0), 2),
        "trace_record": lambda: pallas_trace_record(
            o, o + 1.0, o[:, 0], scene, jnp.int32(0), 2),
        "render_pass": lambda: render_pass(
            scene, cam.derive(), jax.random.PRNGKey(0), width=8, height=8,
            max_depth=2, use_megakernel=True),
        "fast_radiance": lambda: make_fast_radiance(scene, 2)(
            extract_params(scene), o, o + 1.0, o[:, 0], jnp.float32(0)),
        "render_sharded": lambda: render_sharded(
            scene, cam, jax.random.PRNGKey(0), mesh, use_megakernel=True),
        "sharded_train_step": lambda: (lambda p, s, step: step(
            p, s, jax.random.PRNGKey(0), jnp.zeros((8, 8, 3))))(
            *make_sharded_train_step(scene, cam, mesh, spp=2,
                                     use_megakernel=True)),
    }


@pytest.mark.parametrize("entry", ["trace_paths", "trace_record", "render_pass",
                                   "fast_radiance", "render_sharded",
                                   "sharded_train_step"])
def test_kernel_off_gpu_needs_explicit_interpret(entry):
    """Off the GPU every path to the kernel raises unless the caller passed
    interpret=True: nothing falls back to the interpreter on its own."""
    with pytest.raises(ValueError, match="compiled for the GPU"):
        _entry_points()[entry]()


@pytest.mark.parametrize("kind", ["paths", "record_miss", "record"])
def test_megakernel_lowers_for_cuda(kind, monkeypatch):
    """The kernel lowers through Pallas's Triton route for the CUDA platform
    at the cover scene's width and depth 50 (lowering needs no GPU; only
    compiling to the card's code does)."""
    monkeypatch.setattr(mk, "_check_backend", lambda interpret: None)
    scene = make_cover_scene(seed=0)
    o = jnp.zeros((1000, 3))
    if kind == "record":
        f = lambda o, s: pallas_trace_record(o, o + 1.0, o[:, 0], scene, s, 50)
    else:
        f = lambda o, s: pallas_trace_paths(o, o + 1.0, o[:, 0], scene, s, 50,
                                            record_miss=kind == "record_miss")
    text = jax.jit(f).trace(o, jnp.int32(1)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
