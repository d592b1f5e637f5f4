"""Every matrix product on the gradient and intersection paths asks for
HIGHEST precision: on a GPU a float32 product at default precision may run
in TF32 (about three decimal digits), which would make the replay's gathered
sphere attributes disagree with the forward pass. Read from the jaxprs of the
forward and the gradient."""

import jax
import jax.extend
import jax.numpy as jnp
import pytest

from raytracingproject_tpu.camera import Camera, generate_rays
from raytracingproject_tpu.grad.inverse import extract_params
from raytracingproject_tpu.scene import make_three_sphere_scene

HIGHEST = jax.lax.Precision.HIGHEST


def _dot_precisions(jaxpr):
    """The `precision` of every dot_general in a jaxpr, nested jaxprs (scan,
    cond, while, remat, pjit, custom rules) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(x, jax.extend.core.ClosedJaxpr):
                    out.extend(_dot_precisions(x.jaxpr))
                elif isinstance(x, jax.extend.core.Jaxpr):
                    out.extend(_dot_precisions(x))
    return out


def _assert_all_highest(fn, *args):
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no dot_general found: the check would prove nothing"
    bad = [p for p in precs if p is None or any(q != HIGHEST for q in p)]
    assert not bad, f"{len(bad)} of {len(precs)} dot_generals lack HIGHEST: {bad}"


def _rays(n=64, depth=3):
    scene = make_three_sphere_scene()
    cam = Camera(aspect_ratio=1.0, image_width=16, samples_per_pixel=1,
                 max_depth=depth, vfov=90.0, lookfrom=(0.0, 0.0, 0.0),
                 lookat=(0.0, 0.0, -1.0))
    idx = jnp.arange(n) % 256
    o, d, t = generate_rays(cam.derive(), (idx % 16).astype(jnp.int32),
                            (idx // 16).astype(jnp.int32), jax.random.PRNGKey(0))
    return scene, o, d, t


@pytest.mark.parametrize("gather,depth", [(None, 3), (None, 20), ("colT", 3)])
def test_replay_products_highest(gather, depth):
    """replay_radiance forward and gradient, for each gather form: the take
    forward (depth <= 16), the one-hot forward (deeper), and colT."""
    from raytracingproject_tpu.grad.replay import replay_radiance, xla_trace_record

    scene, o, d, t = _rays(depth=depth)
    _, res = xla_trace_record(scene, o, d, t, jax.random.PRNGKey(1), depth)

    def loss(p):
        return jnp.sum(replay_radiance(p, scene, o, d, t, res, gather=gather))

    _assert_all_highest(jax.value_and_grad(loss), extract_params(scene))


def test_closest_hit_products_highest():
    from raytracingproject_tpu.ops.intersect import closest_hit

    scene, o, d, t = _rays()
    _assert_all_highest(
        lambda c0: closest_hit(o, d, t, c0, scene.center_delta, scene.radius).t,
        scene.center0)


def test_soft_primary_radiance_products_highest():
    from raytracingproject_tpu.grad.edge import soft_primary_radiance

    scene, o, d, t = _rays()

    def loss(p):
        return jnp.sum(soft_primary_radiance(
            p, scene, o, d, t, jax.random.PRNGKey(2), 3, 0.05))

    _assert_all_highest(jax.value_and_grad(loss), extract_params(scene))
