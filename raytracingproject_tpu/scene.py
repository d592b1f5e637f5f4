"""Scene representation: struct-of-arrays pytree of spheres + materials.

Replaces the reference's `hittable_list` of `shared_ptr<hittable>` with
virtual-dispatch materials (src/hittable_list.h, src/material.h) with flat
differentiable arrays. Material dispatch becomes a masked select over
`mat_type`; every float leaf is a gradient target for inverse rendering.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import jax.numpy as jnp

from raytracingproject_tpu.config import LAMBERTIAN, METAL, DIELECTRIC


class Scene(NamedTuple):
    """SoA sphere scene. N spheres; all arrays share the leading axis.

    A stationary sphere (src/sphere.h:9-14) has center_delta == 0; a moving
    sphere (src/sphere.h:19-28) lerps center0 -> center0+center_delta by ray
    time. Material params are stored for every sphere regardless of type;
    `mat_type` selects which scatter rule applies (0=lambertian, 1=metal,
    2=dielectric — src/material.h:16-81).
    """

    center0: jnp.ndarray       # [N, 3]
    center_delta: jnp.ndarray  # [N, 3]
    radius: jnp.ndarray        # [N]
    mat_type: jnp.ndarray      # [N] int32
    albedo: jnp.ndarray        # [N, 3]
    fuzz: jnp.ndarray          # [N]  (metal only; clamped <= 1 at build)
    ior: jnp.ndarray           # [N]  (dielectric only)

    @property
    def num_spheres(self) -> int:
        return self.center0.shape[0]

    def pad_to(self, n: int) -> "Scene":
        """Pad to a static capacity with inert spheres (radius 0 at infinity).

        The analog of the reference's fixed-capacity
        `DataBuffer<Sphere, 200>` (src/vulkan/graphical_environment_vulkan.h:141):
        static shapes keep XLA from recompiling as spheres are appended.
        """
        cur = self.num_spheres
        if cur > n:
            raise ValueError(f"scene has {cur} spheres > capacity {n}")
        if cur == n:
            return self
        pad = n - cur
        far = np.zeros((pad, 3), np.float32)
        far[:, 1] = 1e9  # parked far away; radius 0 never intersects
        return Scene(
            center0=jnp.concatenate([self.center0, jnp.asarray(far)]),
            center_delta=jnp.concatenate(
                [self.center_delta, jnp.zeros((pad, 3), self.center_delta.dtype)]
            ),
            radius=jnp.concatenate([self.radius, jnp.zeros((pad,), self.radius.dtype)]),
            mat_type=jnp.concatenate(
                [self.mat_type, jnp.zeros((pad,), jnp.int32)]
            ),
            albedo=jnp.concatenate([self.albedo, jnp.zeros((pad, 3), self.albedo.dtype)]),
            fuzz=jnp.concatenate([self.fuzz, jnp.zeros((pad,), self.fuzz.dtype)]),
            ior=jnp.concatenate([self.ior, jnp.ones((pad,), self.ior.dtype)]),
        )


class SceneBuilder:
    """Imperative scene construction, mirroring `hittable_list::add`
    (src/hittable_list.h:17-23) + the material constructors.
    """

    def __init__(self) -> None:
        self._rows: list[tuple] = []

    def _add(self, center0, center_delta, radius, mat, albedo, fuzz, ior) -> None:
        self._rows.append(
            (
                np.asarray(center0, np.float64),
                np.asarray(center_delta, np.float64),
                float(radius),
                int(mat),
                np.asarray(albedo, np.float64),
                float(fuzz),
                float(ior),
            )
        )

    def add_lambertian(self, center, radius, albedo, center2=None) -> "SceneBuilder":
        """Diffuse sphere (src/material.h:16-30); `center2` makes it a moving
        sphere (src/sphere.h:19-28)."""
        delta = (np.asarray(center2, np.float64) - np.asarray(center, np.float64)
                 if center2 is not None else np.zeros(3))
        self._add(center, delta, radius, LAMBERTIAN, albedo, 0.0, 1.0)
        return self

    def add_metal(self, center, radius, albedo, fuzz=0.0, center2=None) -> "SceneBuilder":
        """Metal sphere; fuzz clamped to <= 1 (src/material.h:34)."""
        delta = (np.asarray(center2, np.float64) - np.asarray(center, np.float64)
                 if center2 is not None else np.zeros(3))
        self._add(center, delta, radius, METAL, albedo, min(float(fuzz), 1.0), 1.0)
        return self

    def add_dielectric(self, center, radius, ior=1.5, center2=None) -> "SceneBuilder":
        """Glass sphere (src/material.h:49-81); attenuation is fixed (1,1,1)."""
        delta = (np.asarray(center2, np.float64) - np.asarray(center, np.float64)
                 if center2 is not None else np.zeros(3))
        self._add(center, delta, radius, DIELECTRIC, np.ones(3), 0.0, float(ior))
        return self

    def build(self, dtype=jnp.float32) -> Scene:
        if not self._rows:
            raise ValueError("empty scene")
        c0, cd, r, m, al, fz, ir = zip(*self._rows)
        return Scene(
            center0=jnp.asarray(np.stack(c0), dtype),
            center_delta=jnp.asarray(np.stack(cd), dtype),
            radius=jnp.asarray(np.array(r), dtype),
            mat_type=jnp.asarray(np.array(m), jnp.int32),
            albedo=jnp.asarray(np.stack(al), dtype),
            fuzz=jnp.asarray(np.array(fz), dtype),
            ior=jnp.asarray(np.array(ir), dtype),
        )


def make_cover_scene(seed: int = 0, dtype=jnp.float32) -> Scene:
    """The RTWeekend final cover scene (reference: src/main.cpp:12-53).

    Ground sphere r=1000; a 22x22 grid of small spheres with material chosen
    by threshold 0.8 (diffuse, *moving*: center2 = center + (0, U(0,0.5), 0)),
    0.95 (metal, albedo in [0.5,1], fuzz in [0,0.5]), else glass ir=1.5;
    grid spheres within 0.9 of (4, 0.2, 0) are skipped; three big spheres:
    glass@(0,1,0), lambertian(0.4,0.2,0.1)@(-4,1,0), metal(0.7,0.6,0.5)@(4,1,0).

    The reference uses a default-seeded global mt19937 (src/rtweekend.h:25-34);
    we use a seeded numpy Generator — same distributions, different stream.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, c + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
                b.add_lambertian(center, 0.2, albedo, center2=center2)
            elif choose_mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                b.add_metal(center, 0.2, albedo, fuzz)
            else:
                b.add_dielectric(center, 0.2, 1.5)

    b.add_dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    return b.build(dtype)


def make_cover_scene_reference(dtype=jnp.float32, arg_order: str = "rl") -> Scene:
    """The cover scene with the EXACT sphere layout of the reference's
    committed golden render.

    The reference generates the scene from one default-seeded global
    std::mt19937 (src/rtweekend.h:25-29, src/main.cpp:17-43); that stream
    is deterministic, so replaying it bit-exactly (utils/mt19937.py)
    reproduces the same ~485 sphere positions/materials that produced
    /root/reference/image.ppm — which is what makes per-pixel golden-image
    comparison meaningful (any per-pixel difference is then Monte-Carlo
    sampling noise, not a different scene).

    `arg_order` resolves the one piece the C++ standard leaves open:
    evaluation order of function arguments in `point3(a + 0.9*rd(), 0.2,
    b + 0.9*rd())` and `vec3(rd(), rd(), rd())` (src/main.cpp:20,
    src/vec3.h:63-69). "rl" = right-to-left (MSVC's order — the golden
    image came from the author's Windows build), "lr" = left-to-right.
    The golden test pins the order that matches the committed image.
    """
    from raytracingproject_tpu.utils.mt19937 import MT19937

    gen = MT19937()
    rl = arg_order == "rl"

    def rd():
        return gen.canonical()

    def vec_random(lo=0.0, hi=1.0):
        # vec3(rd, rd, rd): MSVC evaluates the ctor args right-to-left,
        # so the first draw lands in z (src/vec3.h:63-69)
        a, b_, c = (gen.uniform(lo, hi) for _ in range(3))
        return np.array([c, b_, a]) if rl else np.array([a, b_, c])

    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))

    for a in range(-11, 11):
        for c in range(-11, 11):
            choose_mat = rd()
            jx, jz = rd(), rd()
            if rl:
                jx, jz = jz, jx  # z-arg's draw happened first
            center = np.array([a + 0.9 * jx, 0.2, c + 0.9 * jz])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                # albedo = color::random() * color::random(): with RL
                # evaluation the RIGHT operand's three draws happen first
                v1 = vec_random()
                v2 = vec_random()
                albedo = (v2 * v1) if rl else (v1 * v2)
                center2 = center + np.array([0.0, gen.uniform(0.0, 0.5), 0.0])
                b.add_lambertian(center, 0.2, albedo, center2=center2)
            elif choose_mat < 0.95:
                albedo = vec_random(0.5, 1.0)
                fuzz = gen.uniform(0.0, 0.5)
                b.add_metal(center, 0.2, albedo, fuzz)
            else:
                b.add_dielectric(center, 0.2, 1.5)

    b.add_dielectric((0.0, 1.0, 0.0), 1.0, 1.5)
    b.add_lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1))
    b.add_metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0)
    return b.build(dtype)


def make_three_sphere_scene(dtype=jnp.float32) -> Scene:
    """Benchmark config 2 (BASELINE.md): lambertian + metal + dielectric trio
    with a ground plane — the classic RTWeekend chapter scene."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0))
    b.add_lambertian((0.0, 0.0, -1.0), 0.5, (0.1, 0.2, 0.5))
    b.add_dielectric((-1.0, 0.0, -1.0), 0.5, 1.5)
    b.add_metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.0)
    return b.build(dtype)


def make_minimal_scene(dtype=jnp.float32) -> Scene:
    """Benchmark config 1 (BASELINE.md): one Lambertian sphere + ground."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -100.5, -1.0), 100.0, (0.5, 0.5, 0.5))
    b.add_lambertian((0.0, 0.0, -1.0), 0.5, (0.7, 0.3, 0.3))
    return b.build(dtype)


def make_random_scene(n: int, seed: int = 0, extent: float = 22.0,
                      dtype=jnp.float32) -> Scene:
    """`n` random small spheres + ground — the cover-scene recipe
    (src/main.cpp:14-41) scaled to arbitrary sphere counts for acceleration-
    structure benchmarks (BASELINE has no counterpart; the reference caps at
    ~485 spheres)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    half = extent / 2.0
    for _ in range(n - 1):
        choose_mat = rng.random()
        center = np.array([
            rng.uniform(-half, half), rng.uniform(0.15, 0.45), rng.uniform(-half, half)
        ])
        radius = rng.uniform(0.1, 0.3)
        if choose_mat < 0.8:
            albedo = rng.random(3) * rng.random(3)
            center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
            b.add_lambertian(center, radius, albedo, center2=center2)
        elif choose_mat < 0.95:
            b.add_metal(center, radius, rng.uniform(0.5, 1.0, 3), rng.uniform(0.0, 0.5))
        else:
            b.add_dielectric(center, radius, 1.5)
    return b.build(dtype)


def make_ground_scene(dtype=jnp.float32) -> Scene:
    """The reference unit test's world: only the r=1000 ground sphere
    (tests/tests.cpp:26-29)."""
    b = SceneBuilder()
    b.add_lambertian((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5))
    return b.build(dtype)
