"""Scene builders of the JAX package's ``scene/builders.py``, as host-side
constructors: the same values, the same float32 rounding and the same seeded
generators, so the port's tensors equal the JAX builders' arrays exactly.
Scenes are built on the CPU; ``Renderer`` moves them to its device."""
from __future__ import annotations

import dataclasses

import numpy as np

from . import meshes
from .scene import Camera, Scene, Sky, _f32, make_scene


class _SceneBuilder:
    """Incremental scene assembly (Application.cpp's push_back flow)."""

    _FIELDS = ("albedo", "f0", "f80", "emission", "transmission", "roughness",
               "ior_minus_one")

    def __init__(self):
        self.mats = {k: [] for k in self._FIELDS}
        self.centers = []
        self.radii = []
        self.mat_ids = []
        # v0, v1, v2 ([T, 3]) and material_id ([T]): lists of rows, or whole
        # arrays for a mesh
        self.tris = {"v0": [], "v1": [], "v2": [], "material_id": []}

    def material(self, albedo=(0, 0, 0), f0=(0, 0, 0), f80=(1, 1, 1),
                 emission=(0, 0, 0), transmission=(0, 0, 0), roughness=0.0,
                 ior_minus_one=0.0) -> int:
        for k, v in zip(self._FIELDS, (albedo, f0, f80, emission, transmission,
                                       roughness, ior_minus_one)):
            self.mats[k].append(v)
        return len(self.mats["albedo"]) - 1

    def sphere(self, center, radius, mat_id):
        self.centers.append(center)
        self.radii.append(radius)
        self.mat_ids.append(mat_id)

    def triangle(self, v0, v1, v2, mat_id):
        for k, v in zip(("v0", "v1", "v2", "material_id"),
                        (v0, v1, v2, mat_id)):
            self.tris[k].append(v)

    def quad(self, v0, v1, v2, v3, mat_id):
        """Two triangles (v0, v1, v2) and (v0, v2, v3)."""
        self.triangle(v0, v1, v2, mat_id)
        self.triangle(v0, v2, v3, mat_id)

    def build(self, camera: Camera, sky: Sky) -> Scene:
        materials = {
            k: np.asarray(v, np.float32).reshape(
                (-1,) if k in ("roughness", "ior_minus_one") else (-1, 3))
            for k, v in self.mats.items()
        }
        tris = None
        if len(self.tris["v0"]):
            tris = {k: np.asarray(v) for k, v in self.tris.items()}
        return make_scene(
            np.asarray(self.centers, np.float32).reshape(-1, 3),
            np.asarray(self.radii, np.float32),
            np.asarray(self.mat_ids, np.int32),
            materials, camera, sky, triangles=tris,
        )


def default_scene(width: int = 256, height: int = 256) -> Scene:
    """Hero scene (Application.cpp:33-101): floor, 3 colored sphere lights,
    5 material-demo spheres, black ambient -> pure NEE lighting."""
    b = _SceneBuilder()
    floor = b.material(albedo=(1, 1, 1), f0=(0.8, 0.8, 0.8), f80=(0.9, 0.9, 0.9), roughness=0.2)
    b.sphere((0.3, -1.47, 0.0), 1.5, floor)
    m = b.material(emission=(2.5, 2.5, 20.0), albedo=(1, 1, 1), roughness=1.0)
    b.sphere((0.29999, 0.0801, 0.0), 0.05, m)
    m = b.material(emission=(15.0, 15.0, 15.0), albedo=(1, 1, 1), roughness=1.0)
    b.sphere((0.3302, 0.36165, 0.7119), 0.05, m)
    m = b.material(emission=(200.0, 17.0, 25.0), albedo=(1, 1, 1), roughness=1.0)
    b.sphere((-0.4857, -0.0242, -0.41383), 0.05, m)
    m = b.material(albedo=(0.793, 0.793, 0.664), f0=(0.04, 0.04, 0.04), f80=(0.5, 0.5, 0.5), roughness=0.85)
    b.sphere((0.3, 1.7, 0.0), 1.5, m)
    m = b.material(
        albedo=(0.05, 0.05, 0.05), f0=(0.03, 0.03, 0.03), f80=(0.5, 0.5, 0.5),
        transmission=(0.95, 0.95, 0.95), ior_minus_one=0.44, roughness=0.05,
    )
    b.sphere((0.018, 0.022, 0.07), 0.02, m)
    m = b.material(albedo=(1, 1, 1), f0=(0.944, 0.776, 0.373), f80=(0.8, 0.8, 0.6), roughness=0.15)
    b.sphere((-0.037, 0.022, 0.00), 0.03, m)
    m = b.material(
        albedo=(1, 1, 1), f0=(0.076288, 0.077375, 0.078887), f80=(0.47990, 0.48028, 0.48080),
        transmission=(0.670, 0.764, 0.855), ior_minus_one=0.762, roughness=0.1,
    )
    b.sphere((-0.0846, -0.0334, 0.283), 0.012, m)
    m = b.material(albedo=(1, 1, 1), f0=(0.04, 0.04, 0.04), f80=(0.5, 0.5, 0.5), roughness=0.8)
    b.sphere((0.03863, -0.00788, 0.2835), 0.012, m)
    cam = Camera.create(
        eye=(-0.2, 0.3, 1), forward=(0.1, -0.4, -1), width=width, height=height,
        focal_length=40.0, focus_distance=0.0, f_number=16.0, exposure=1.0,
    )
    return b.build(cam, Sky.constant((0.0, 0.0, 0.0)))


def dof_scene(width: int = 256, height: int = 256) -> Scene:
    """The hero through a thin lens focused 1.3 away with an aperture
    radius of 0.05: the camera of the `dof` golden (the JAX package's
    tests/goldens/regen.py). Render it with ``enable_dof=True``."""
    scene = default_scene(width, height)
    return dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, focus_distance=_f32(1.3),
        aperture_radius=_f32(0.05)))


def white_furnace_scene(width: int = 256, height: int = 256) -> Scene:
    """Energy-conservation test (Application.cpp:218-223): unit-albedo sphere
    in a uniform white sky; a correct integrator renders it invisible."""
    b = _SceneBuilder()
    m = b.material(albedo=(1.0, 1.0, 1.0), roughness=1.0)
    b.sphere((0.0, 0.0, 0.0), 1.0, m)
    cam = Camera.create(eye=(0, 0, 3), forward=(0, 0, -1), width=width, height=height)
    return b.build(cam, Sky.constant((1.0, 1.0, 1.0)))


def bvh_test_scene(width: int = 512, height: int = 512, num_spheres: int = 255,
                   seed: int = 0x04D15A07) -> Scene:
    """Random sphere field (Application.cpp:102-122): y in [0,100], xz in
    [-100,100], radius in [0.3,20], with a 5-material palette."""
    b = _SceneBuilder()
    palette = [
        b.material(albedo=(0.8, 0.3, 0.3), roughness=1.0),
        b.material(albedo=(0.3, 0.8, 0.3), roughness=1.0),
        b.material(albedo=(0.3, 0.3, 0.8), roughness=1.0),
        b.material(albedo=(0.7, 0.7, 0.7), roughness=1.0),
        b.material(emission=(40.0, 38.0, 30.0), albedo=(1, 1, 1), roughness=1.0),
    ]
    rng = np.random.Generator(np.random.MT19937(seed))
    for _ in range(num_spheres):
        r = rng.uniform(0.3, 20.0)
        b.sphere(
            (rng.uniform(-100, 100), rng.uniform(0, 100), rng.uniform(-100, 100)),
            r,
            palette[int(rng.integers(0, len(palette)))],
        )
    cam = Camera.create(eye=(0, 60, 300), forward=(0, 0, -1), width=width, height=height)
    return b.build(cam, Sky.constant((1.0, 1.0, 1.0)))


BRDF_TEST_PROPERTIES = (
    "roughness", "roughness_diffuse", "ior_reflection", "ior_refraction",
    "roughness_glass", "absorption", "absorption_roughness",
    "refraction_to_diffuse",
)


def brdf_test_scene(width: int = 512, height: int = 512, gradations: int = 10,
                    prop: str = "roughness") -> Scene:
    """Parameter-gradation lineup (Application.cpp:123-217): `gradations`
    spheres sweeping one material property over a giant floor sphere with
    a sphere light. The reference enumerates eight Properties cases but
    hard-codes Roughness (:159); all eight render here (the glass and
    absorption cases under brdf='principled'). Material values per case are
    the reference's (:161-215)."""
    if prop not in BRDF_TEST_PROPERTIES:
        raise ValueError(f"unknown brdf_test property {prop!r}")
    b = _SceneBuilder()
    floor = b.material(albedo=(0.1, 0.1, 0.1), roughness=1.0)
    b.sphere((0.0, -1001.0, 0.0), 1000.0, floor)
    light = b.material(emission=(100.0, 100.0, 100.0))
    b.sphere((0.0, 10.0, 0.0), np.sqrt(5.0), light)  # radius_sq = 5.0 in ref

    def lerp(a, c, t):
        return tuple((1 - t) * np.asarray(a) + t * np.asarray(c))

    glassy = dict(f0=(0.04,) * 3, f80=(0.5,) * 3)
    for i in range(gradations):
        t = i / (gradations - 1)
        m = {
            "roughness": lambda: b.material(
                f0=(1, 1, 1), f80=(1, 1, 1), albedo=(0, 0, 0), roughness=t),
            "roughness_diffuse": lambda: b.material(
                albedo=(0.75, 0.25, 0.25), roughness=t, **glassy),
            "ior_reflection": lambda: b.material(
                albedo=(0.7, 0.5, 0.3), ior_minus_one=t, **glassy),
            "ior_refraction": lambda: b.material(
                transmission=(0.95,) * 3, ior_minus_one=t * 0.5, **glassy),
            "roughness_glass": lambda: b.material(
                transmission=(0.95,) * 3, ior_minus_one=0.1, roughness=t,
                **glassy),
            "absorption": lambda: b.material(
                transmission=lerp((0.95,) * 3, (0, 0.95, 0.95), t),
                ior_minus_one=0.1, **glassy),
            "absorption_roughness": lambda: b.material(
                transmission=(0.0, 0.95, 0.95), ior_minus_one=0.1,
                roughness=t, **glassy),
            "refraction_to_diffuse": lambda: b.material(
                albedo=lerp((0, 0, 0), (0, 0.95, 0.95), t),
                transmission=lerp((0.95,) * 3, (0, 0, 0), t), **glassy),
        }[prop]()
        x = (i * 2 - gradations) * 1.25 + 1.0
        b.sphere((x, i * 0.1, 0.0), 1.0, m)
    cam = Camera.create(eye=(0, 0, gradations * 2.8), forward=(0, 0, -1),
                        width=width, height=height)
    return b.build(cam, Sky.constant((1.0, 1.0, 1.0)))


def cornell_box_scene(width: int = 512, height: int = 512) -> Scene:
    """Triangle Cornell box with an emissive ceiling quad: the standard
    layout in the box [0,1]^3, open at z = 1, the camera looking down -Z, and
    two spheres in place of the classic boxes, so that mixed geometry is
    exercised."""
    b = _SceneBuilder()
    white = b.material(albedo=(0.73, 0.73, 0.73), roughness=1.0)
    red = b.material(albedo=(0.65, 0.05, 0.05), roughness=1.0)
    green = b.material(albedo=(0.12, 0.45, 0.15), roughness=1.0)
    light = b.material(emission=(17.0, 12.0, 4.0), albedo=(0.78, 0.78, 0.78))
    b.quad((0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1), white)  # floor
    b.quad((0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0), white)  # ceiling
    b.quad((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0), white)  # back wall
    b.quad((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0), red)  # left wall
    b.quad((1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1), green)  # right wall
    # ceiling light quad, slightly below the ceiling
    l0, l1 = 0.35, 0.65
    y = 0.999
    b.quad((l0, y, l0), (l1, y, l0), (l1, y, l1), (l0, y, l1), light)
    glossy = b.material(albedo=(0.8, 0.8, 0.9), roughness=0.3)
    b.sphere((0.3, 0.18, 0.35), 0.18, glossy)
    diffuse = b.material(albedo=(0.9, 0.7, 0.4), roughness=1.0)
    b.sphere((0.68, 0.13, 0.6), 0.13, diffuse)
    cam = Camera.create(
        eye=(0.5, 0.5, 2.2), forward=(0, 0, -1), width=width, height=height,
        focal_length=35.0,
    )
    return b.build(cam, Sky.constant((0.0, 0.0, 0.0)))


def random_spheres_scene(width: int = 512, height: int = 512,
                         num_spheres: int = 1000, seed: int = 1234,
                         emissive_fraction: float = 0.02) -> Scene:
    """Parameterized sphere field (BASELINE.json config 2: 1k spheres)."""
    b = _SceneBuilder()
    rng = np.random.Generator(np.random.MT19937(seed))
    mats = []
    for _ in range(16):
        mats.append(
            b.material(albedo=tuple(rng.uniform(0.2, 0.9, 3)), roughness=float(rng.uniform(0.1, 1.0)))
        )
    em = b.material(emission=(30.0, 28.0, 24.0), albedo=(1, 1, 1), roughness=1.0)
    for _ in range(num_spheres):
        r = float(rng.uniform(0.3, 3.0))
        pos = (float(rng.uniform(-100, 100)), float(rng.uniform(0, 60)), float(rng.uniform(-100, 100)))
        mat = em if rng.uniform() < emissive_fraction else mats[int(rng.integers(0, len(mats)))]
        b.sphere(pos, r, mat)
    cam = Camera.create(eye=(0, 40, 220), forward=(0, -0.1, -1), width=width, height=height)
    return b.build(cam, Sky.constant((0.5, 0.6, 0.8)))


def mesh_scene(width: int = 512, height: int = 512, subdivisions: int = 6,
               obj_path=None, uv_res: int = 0) -> Scene:
    """Large triangle-mesh scene: a displaced icosphere (20 * 4^k triangles),
    a displaced UV sphere of an exact count (2 * uv_res^2 triangles: 100,352
    at uv_res=224, 1,312,200 at 810) or a user OBJ, over a ground sphere, lit
    by a sphere light and a dim sky."""
    b = _SceneBuilder()
    ground = b.material(albedo=(0.6, 0.6, 0.6), roughness=1.0)
    b.sphere((0.0, -1000.8, 0.0), 1000.0, ground)
    light = b.material(emission=(400.0, 380.0, 320.0), albedo=(1, 1, 1))
    b.sphere((3.0, 4.0, 2.0), 0.5, light)
    body = b.material(albedo=(0.75, 0.71, 0.68), roughness=0.9)
    if obj_path:
        verts, faces = meshes.load_obj(obj_path)
        # normalize into a unit-ish object above the ground
        verts = verts - verts.mean(0)
        verts = verts / np.abs(verts).max()
    elif uv_res:
        verts, faces = meshes.displaced_uv_sphere(uv_res, uv_res)
    else:
        verts, faces = meshes.displaced_icosphere(subdivisions)
    # the mesh's arrays go through whole (no list of a million rows)
    b.tris = meshes.mesh_to_triangles(verts, faces, body)
    cam = Camera.create(
        eye=(0, 0.4, 3.2), forward=(0, -0.1, -1), width=width, height=height,
        focal_length=45.0,
    )
    return b.build(cam, Sky.constant((0.15, 0.18, 0.25)))


SCENES = {
    "default": default_scene,
    "white_furnace": white_furnace_scene,
    "bvh_test": bvh_test_scene,
    "brdf_test": brdf_test_scene,
    "cornell": cornell_box_scene,
    "random_spheres": random_spheres_scene,
    "mesh": mesh_scene,
}
