"""Path-replay backpropagation (grad/replay.py) equivalence tests.

The replay with residuals recorded from the XLA forward must reproduce
(1) the forward radiance exactly and (2) reverse-mode gradients through the
full renderer analytically — same estimator, different evaluation order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.camera import Camera, generate_rays
from raytracingproject_tpu.grad.inverse import apply_params, extract_params
from raytracingproject_tpu.grad.replay import replay_radiance, xla_trace_record
from raytracingproject_tpu.render import ray_color
from raytracingproject_tpu.scene import make_cover_scene, make_three_sphere_scene

DEPTH = 6


def _rays(scene_cam, n_rays, key):
    cam, w, h = scene_cam
    idx = jax.random.randint(key, (n_rays,), 0, w * h)
    i = (idx % w).astype(jnp.int32)
    j = (idx // w).astype(jnp.int32)
    return generate_rays(cam, i, j, jax.random.fold_in(key, 1))


def _setup(scene_fn, **cam_kw):
    scene = scene_fn()
    cam = Camera(**cam_kw)
    d = cam.derive()
    return scene, (d, cam.image_width, cam.image_height)


CAM3 = dict(
    aspect_ratio=16.0 / 9.0, image_width=120, samples_per_pixel=1, max_depth=DEPTH,
    vfov=90.0, lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
)
CAM_COVER = dict(
    aspect_ratio=16.0 / 9.0, image_width=120, samples_per_pixel=1, max_depth=DEPTH,
    vfov=20.0, lookfrom=(13.0, 2.0, 3.0), lookat=(0.0, 0.0, 0.0),
    defocus_angle=0.6, focus_dist=10.0,
)


def test_record_matches_ray_color():
    """xla_trace_record's radiance equals ray_color to float precision
    (same key; the two loops fuse the rsqrt-form normalize differently, so
    ~1e-5 rel is fusion noise, not a semantic difference)."""
    scene, sc = _setup(make_three_sphere_scene, **CAM3)
    o, d, t = _rays(sc, 4096, jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(9)
    rad_rc = ray_color(scene, o, d, t, key, DEPTH)
    rad_rec, _ = xla_trace_record(scene, o, d, t, key, DEPTH)
    np.testing.assert_allclose(np.asarray(rad_rec), np.asarray(rad_rc),
                               atol=5e-5, rtol=5e-5)


def test_replay_reproduces_forward():
    """Replaying the residuals at the recording params reproduces radiance."""
    for scene_fn, cam_kw in [(make_three_sphere_scene, CAM3),
                             (make_cover_scene, CAM_COVER)]:
        scene, sc = _setup(scene_fn, **cam_kw)
        o, d, t = _rays(sc, 4096, jax.random.PRNGKey(1))
        rad, res = xla_trace_record(scene, o, d, t, jax.random.PRNGKey(7), DEPTH)
        rad_rp = replay_radiance(extract_params(scene), scene, o, d, t, res)
        a, b = np.asarray(rad), np.asarray(rad_rp)
        # A handful of grazing-boundary rays may diverge: the replay's
        # elementwise dot products differ from closest_hit's einsum by ~1
        # ulp, which frozen topology can amplify at silhouettes. Everything
        # else must match to float precision.
        mismatched = (np.abs(a - b).max(axis=-1) > 2e-5).mean()
        assert mismatched < 2e-3, f"{scene_fn.__name__}: {mismatched:.2%} rays differ"
        np.testing.assert_allclose(
            b.mean(axis=0), a.mean(axis=0), atol=1e-4,
            err_msg=f"{scene_fn.__name__}",
        )




def _assert_grads_match(scene, g_full, g_rp, tol):
    """Compare gradient pytrees. fuzz entries at exactly fuzz == 0 are the
    one documented estimator difference (replay takes 0 there; the recorded
    direction carries no fuzz-sample information, see grad/replay.py)."""
    fuzz0 = np.asarray(scene.fuzz) <= 1e-6
    for name in g_full._fields:
        a = np.asarray(getattr(g_full, name))
        b = np.asarray(getattr(g_rp, name))
        if name == "fuzz":
            a = a[~fuzz0]
            b = b[~fuzz0]
        # relative-norm error: elementwise comparison is brittle for the few
        # grazing-boundary rays whose replayed geometry differs by ~1 ulp
        # (see test_replay_reproduces_forward); the estimator must agree in
        # aggregate.
        denom = np.linalg.norm(a) + 1e-6
        rel = np.linalg.norm(b - a) / denom
        assert rel < tol, f"{name}: relative gradient error {rel:.4f} >= {tol}"

def test_replay_gradients_match_full_reverse_mode():
    """jax.grad through replay == jax.grad through the full renderer.

    Both treat RNG draws and discrete topology as constants; the replay just
    avoids re-intersecting every sphere. Weighted-sum cotangent exercises
    every output channel."""
    scene, sc = _setup(make_three_sphere_scene, **CAM3)
    o, d, t = _rays(sc, 2048, jax.random.PRNGKey(2))
    key = jax.random.PRNGKey(11)
    w = jax.random.uniform(jax.random.PRNGKey(3), (o.shape[0], 3))

    def loss_full(params):
        rad = ray_color(apply_params(scene, params), o, d, t, key, DEPTH)
        return jnp.sum(rad * w)

    _, res = xla_trace_record(scene, o, d, t, key, DEPTH)

    def loss_replay(params):
        return jnp.sum(replay_radiance(params, scene, o, d, t, res) * w)

    g_full = jax.grad(loss_full)(extract_params(scene))
    g_rp = jax.grad(loss_replay)(extract_params(scene))
    _assert_grads_match(scene, g_full, g_rp, 2e-3)


def test_replay_gradients_match_on_cover_scene():
    """Same equivalence on the full cover scene (all three materials,
    motion blur, ~488 spheres)."""
    scene, sc = _setup(make_cover_scene, **CAM_COVER)
    o, d, t = _rays(sc, 1024, jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(13)
    w = jax.random.uniform(jax.random.PRNGKey(5), (o.shape[0], 3))

    rad, res = xla_trace_record(scene, o, d, t, key, DEPTH)
    # Exclude the few grazing-boundary rays whose replayed geometry diverges
    # (~1-ulp closest-hit differences amplified through frozen topology, see
    # test_replay_reproduces_forward) — on consistent rays the two gradient
    # estimators are analytically identical.
    rad_rp = replay_radiance(extract_params(scene), scene, o, d, t, res)
    consistent = jnp.max(jnp.abs(rad - rad_rp), axis=-1) < 2e-5
    w = w * consistent[:, None]

    def loss_full(params):
        rad = ray_color(apply_params(scene, params), o, d, t, key, DEPTH)
        return jnp.sum(rad * w)

    def loss_replay(params):
        return jnp.sum(replay_radiance(params, scene, o, d, t, res) * w)

    g_full = jax.grad(loss_full)(extract_params(scene))
    g_rp = jax.grad(loss_replay)(extract_params(scene))
    _assert_grads_match(scene, g_full, g_rp, 5e-3)


def test_pallas_record_replay_interpret():
    """Megakernel residual recording (interpreted): radiance matches the
    non-recording kernel bit-for-bit (same seed, same random stream), and
    the replay of the residuals rebuilds it."""
    from raytracingproject_tpu.ops.pallas.megakernel import (
        pallas_trace_paths, pallas_trace_record,
    )

    scene, sc = _setup(make_three_sphere_scene, **CAM3)
    o, d, t = _rays(sc, 1024, jax.random.PRNGKey(6))
    kw = dict(interpret=True, block=512)
    rad0 = pallas_trace_paths(o, d, t, scene, jnp.int32(3), 3, **kw)
    rad, res = pallas_trace_record(o, d, t, scene, jnp.int32(3), 3, **kw)
    np.testing.assert_array_equal(np.asarray(rad), np.asarray(rad0))
    assert res.idx.shape == (3, 1024)
    assert set(np.unique(res.idx)) <= set(range(-2, scene.radius.shape[0]))
    assert np.asarray(res.refl).any()  # the dielectric branch bit is recorded

    rad_rp = replay_radiance(extract_params(scene), scene, o, d, t, res)
    a, b = np.asarray(rad), np.asarray(rad_rp)
    mismatched = (np.abs(a - b).max(axis=-1) > 1e-4).mean()
    assert mismatched < 5e-3, f"{mismatched:.2%} rays differ"


def test_fast_radiance_custom_vjp_interpret():
    """make_fast_radiance: forward = megakernel (interpreted), backward =
    replay. Value and gradient must equal the replay of the kernel's own
    residuals (estimator identity with XLA is covered above)."""
    from raytracingproject_tpu.grad.fast import make_fast_radiance
    from raytracingproject_tpu.ops.pallas.megakernel import pallas_trace_record

    scene, sc = _setup(make_three_sphere_scene, **CAM3)
    o, d, t = _rays(sc, 1024, jax.random.PRNGKey(8))
    params = extract_params(scene)
    f = make_fast_radiance(scene, 3, interpret=True)
    w = jax.random.uniform(jax.random.PRNGKey(9), (o.shape[0], 3))
    seed = jnp.float32(3)

    val, g = jax.value_and_grad(
        lambda p: jnp.sum(f(p, o, d, t, seed) * w)
    )(params)

    rad, res = pallas_trace_record(o, d, t, scene, jnp.int32(3), 3, interpret=True)
    g_ref = jax.grad(
        lambda p: jnp.sum(replay_radiance(p, scene, o, d, t, res) * w)
    )(params)
    np.testing.assert_allclose(float(val), float(jnp.sum(rad * w)), rtol=1e-5)
    _assert_grads_match(scene, g_ref, g, 1e-4)


def _mirror_scene():
    """Mirror spheres (metal, fuzz 0): every path is deterministic, so the
    megakernel's forward equals the XLA renderer's whatever the RNG."""
    from raytracingproject_tpu.scene import SceneBuilder

    return (
        SceneBuilder()
        .add_metal(center=(0.0, 0.0, -1.5), radius=0.5,
                   albedo=(0.9, 0.8, 0.7), fuzz=0.0)
        .add_metal(center=(1.1, 0.2, -2.0), radius=0.4,
                   albedo=(0.6, 0.7, 0.9), fuzz=0.0)
        .add_metal(center=(-1.0, -0.3, -1.8), radius=0.45,
                   albedo=(0.7, 0.9, 0.6), fuzz=0.0)
        .build()
    )


@pytest.fixture(scope="module")
def mirror_grads():
    """(gradients through make_fast_radiance, through ray_color) of one
    weighted-radiance loss on the mirror scene; the forwards must agree."""
    from raytracingproject_tpu.grad.fast import make_fast_radiance

    scene = _mirror_scene()
    cam = Camera(**CAM3)
    o, d, t = _rays((cam.derive(), cam.image_width, cam.image_height), 1024,
                    jax.random.PRNGKey(31))
    w = jax.random.uniform(jax.random.PRNGKey(32), (o.shape[0], 3))
    params = extract_params(scene)
    f = make_fast_radiance(scene, 4, interpret=True)
    rad_k = f(params, o, d, t, jnp.float32(5))
    rad_x = ray_color(scene, o, d, t, jax.random.PRNGKey(1), 4)
    np.testing.assert_allclose(np.asarray(rad_k), np.asarray(rad_x), atol=2e-5)
    g_k = jax.grad(lambda p: jnp.sum(f(p, o, d, t, jnp.float32(5)) * w))(params)
    g_x = jax.grad(lambda p: jnp.sum(
        ray_color(apply_params(scene, p), o, d, t, jax.random.PRNGKey(1), 4) * w
    ))(params)
    return g_k, g_x


@pytest.mark.parametrize("field", ["center0", "center_delta", "radius", "albedo"])
def test_fast_radiance_grads_match_xla_reverse_mode(mirror_grads, field):
    """On a scene without randomness, gradients through make_fast_radiance
    (megakernel forward, interpreted; replay backward) equal jax.grad
    through render.ray_color, field by field."""
    g_k, g_x = mirror_grads
    a = np.asarray(getattr(g_x, field))
    b = np.asarray(getattr(g_k, field))
    assert np.abs(a).max() > 0
    rel = np.linalg.norm(b - a) / (np.linalg.norm(a) + 1e-6)
    assert rel < 1e-3, f"{field}: relative gradient error {rel:.2e}"


def test_grouped_replay_matches_ungrouped():
    """Dead-depth-skipping grouped replay (n_groups > 1): radiance and
    gradients must equal the plain replay — the sort/slice/cond machinery
    is a pure evaluation-order change (grad/replay.py docstring). Uses a
    ray count NOT divisible by the group count to exercise the DEAD-padded
    tail slice."""
    scene, sc = _setup(make_cover_scene, **CAM_COVER)
    o, d, t = _rays(sc, 1003, jax.random.PRNGKey(17))
    key = jax.random.PRNGKey(19)
    _, res = xla_trace_record(scene, o, d, t, key, DEPTH)
    params = extract_params(scene)
    w = jax.random.uniform(jax.random.PRNGKey(23), (o.shape[0], 3))

    rad1 = replay_radiance(params, scene, o, d, t, res)
    g1 = jax.grad(
        lambda p: jnp.sum(replay_radiance(p, scene, o, d, t, res) * w)
    )(params)
    for ng in (4, 7):
        radk = replay_radiance(params, scene, o, d, t, res, n_groups=ng)
        np.testing.assert_allclose(
            np.asarray(radk), np.asarray(rad1), atol=1e-6,
            err_msg=f"n_groups={ng}",
        )
        gk = jax.grad(
            lambda p: jnp.sum(
                replay_radiance(p, scene, o, d, t, res, n_groups=ng) * w
            )
        )(params)
        # grouped scans run cond-wrapped steps; XLA fuses the two graphs
        # differently, so gradients agree to float precision (measured
        # 2.6e-5 relative), not bit-exactly
        _assert_grads_match(scene, g1, gk, 2e-4)


def test_replay_dead_depth_predicate_skips():
    """Residuals whose tail bounces are all DEAD must produce identical
    radiance whether the scan runs them or skips them — checked by
    extending the residuals with extra all-DEAD depth rows (as a depth-50
    recording of shallow paths would contain)."""
    scene, sc = _setup(make_three_sphere_scene, **CAM3)
    o, d, t = _rays(sc, 512, jax.random.PRNGKey(29))
    _, res = xla_trace_record(scene, o, d, t, jax.random.PRNGKey(31), DEPTH)
    params = extract_params(scene)
    base = replay_radiance(params, scene, o, d, t, res)

    import jax.numpy as jnp2
    from raytracingproject_tpu.grad.replay import DEAD, PathResiduals

    extra = 10
    res50 = PathResiduals(
        idx=jnp2.concatenate(
            [res.idx, jnp2.full((extra, res.idx.shape[1]), DEAD, res.idx.dtype)]
        ),
        ndir=jnp2.concatenate(
            [res.ndir, jnp2.zeros((extra,) + res.ndir.shape[1:], res.ndir.dtype)]
        ),
        refl=jnp2.concatenate(
            [res.refl, jnp2.zeros((extra,) + res.refl.shape[1:], bool)]
        ),
    )
    deep = replay_radiance(params, scene, o, d, t, res50, n_groups=4)
    np.testing.assert_allclose(np.asarray(deep), np.asarray(base), atol=1e-6)


def test_colT_gather_grads_match_default():
    """The ray-minor transposed one-hot gather (gather="colT") must produce the
    same radiance and gradients as the default replay — it is the same
    one-hot algebra relaid.

    Gradient equality is asserted at depth 3: a SINGLE replay step agrees
    to ~2e-7 (measured), but bounce chains amplify fp noise through
    reflect-derivative curvature factors (~|2t/r| per bounce), so ANY two
    fp-equivalent step implementations diverge by percents at depth 6 —
    the comparison depth must stay in the well-conditioned regime. Values
    (no derivative chains) are asserted at depth 6."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingproject_tpu.camera import Camera, generate_rays
    from raytracingproject_tpu.grad.inverse import extract_params
    from raytracingproject_tpu.grad.replay import (
        replay_radiance, xla_trace_record,
    )
    from raytracingproject_tpu.scene import make_three_sphere_scene

    scene = make_three_sphere_scene()
    cam = Camera(
        aspect_ratio=16.0 / 9.0, image_width=64, samples_per_pixel=1,
        max_depth=6, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
    ).derive()
    idx = jax.random.randint(jax.random.PRNGKey(0), (1500,), 0, 64 * 36)
    o, d, t = generate_rays(
        cam, (idx % 64).astype(jnp.int32), (idx // 64).astype(jnp.int32),
        jax.random.PRNGKey(1),
    )
    params = extract_params(scene)

    def loss(gather, res):
        def f(p):
            out = replay_radiance(p, scene, o, d, t, res, gather=gather)
            return jnp.mean(out ** 2)

        return f

    # depth-6 value equality
    _, res6 = xla_trace_record(scene, o, d, t, jax.random.PRNGKey(2), 6)
    va = loss(None, res6)(params)
    vb = loss("colT", res6)(params)
    np.testing.assert_allclose(float(vb), float(va), rtol=1e-5)

    # depth-2 gradient agreement in f32 (short chain keeps amplification
    # bounded; measured ~1e-6 here vs percents at depth 6)
    _, res2 = xla_trace_record(scene, o, d, t, jax.random.PRNGKey(2), 2)
    ga = jax.grad(loss(None, res2))(params)
    gb = jax.grad(loss("colT", res2))(params)
    for a, b in zip(jax.tree.leaves(ga), jax.tree.leaves(gb)):
        denom = np.linalg.norm(np.asarray(a)) + 1e-12
        rel = np.linalg.norm(np.asarray(b) - np.asarray(a)) / denom
        assert rel < 1e-3, rel


def test_colT_gather_grads_match_default_f64():
    """The decisive equality check: in float64 the two gathers agree to
    1e-14 at depth 6 (measured 1.7e-14) — the f32 depth-6 divergence is
    noise amplified through reflect-curvature chains, not semantics.
    Run in a SUBPROCESS because jax_enable_x64 is process-global."""
    import subprocess
    import sys

    code = """
import os
os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=8'
import jax; jax.config.update('jax_platforms','cpu'); jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp
from raytracingproject_tpu.camera import Camera, generate_rays
from raytracingproject_tpu.grad.inverse import extract_params
from raytracingproject_tpu.grad import replay as rp
from raytracingproject_tpu.scene import make_three_sphere_scene
scene = make_three_sphere_scene()
f64 = lambda tr: jax.tree.map(lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x, tr)
scene = f64(scene)
cam = Camera(aspect_ratio=16/9, image_width=64, samples_per_pixel=1, max_depth=6,
             vfov=90.0, lookfrom=(0,0,0), lookat=(0,0,-1)).derive(jnp.float64)
idx = jax.random.randint(jax.random.PRNGKey(0), (800,), 0, 64*36)
o, d, t = f64(generate_rays(cam, (idx%64).astype(jnp.int32), (idx//64).astype(jnp.int32), jax.random.PRNGKey(1)))
rad, res = rp.xla_trace_record(scene, o, d, t, jax.random.PRNGKey(2), 6)
params = f64(extract_params(scene))
def loss(gather):
    return lambda p: jnp.mean(rp.replay_radiance(p, scene, o, d, t, res, gather=gather) ** 2)
ga = jax.grad(loss(None))(params)
gb = jax.grad(loss('colT'))(params)
rel = max(float(jnp.linalg.norm(a-b)/(jnp.linalg.norm(a)+1e-15))
          for a,b in zip(jax.tree.leaves(ga), jax.tree.leaves(gb)))
assert rel < 1e-9, rel
print('ok', rel)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd="/root/repo", timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "ok" in out.stdout
