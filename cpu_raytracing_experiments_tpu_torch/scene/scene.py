"""Scene model on PyTorch tensors, the counterpart of the JAX package's
``scene/scene.py``: structure-of-arrays spheres, triangles and materials, the
NEE light lists, an equirect sky and a pinhole camera.

The scene plays the part that weights play in a model port: ``Scene.from_numpy``
takes the flat numpy arrays of a scene (``Scene.to_numpy`` gives the same
layout), so both packages can render identical inputs. Builders assemble
scenes on the host; ``Scene.to(device)`` moves one to the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core import fp
from ..core.fp import fma
from ..core.vec import Quat, Vec3
from ..bvh.builder import BVHArrays
from ..bvh.grid import UniformGrid
from ..ops.clustered import ClusteredPrims


def _f32(v, device=None) -> torch.Tensor:
    """0-d float32 tensor of a host value (rounded once, from float64)."""
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def _vec_np(v: Vec3) -> np.ndarray:
    return np.stack([c.cpu().numpy() for c in v], axis=-1)


@dataclasses.dataclass
class SphereGeometry:
    """SoA sphere list (Primitives.hpp:7-17): center, radius^2, material id."""

    center: Vec3  # [P] float32
    radius_sq: torch.Tensor  # [P] float32
    material_id: torch.Tensor  # [P] int32

    @property
    def count(self) -> int:
        return self.radius_sq.shape[0]

    def to(self, device) -> "SphereGeometry":
        return SphereGeometry(self.center.to(device), self.radius_sq.to(device),
                              self.material_id.to(device))


@dataclasses.dataclass
class TriangleGeometry:
    """SoA triangle list: first vertex, the two edges from it, the unit
    geometric normal, the area (for light sampling) and the material id."""

    v0: Vec3  # [T] float32
    e1: Vec3  # [T] v1 - v0
    e2: Vec3  # [T] v2 - v0
    normal: Vec3  # [T]
    material_id: torch.Tensor  # [T] int32
    area: torch.Tensor  # [T] float32

    @property
    def count(self) -> int:
        return self.material_id.shape[0]

    def to(self, device) -> "TriangleGeometry":
        return TriangleGeometry(
            self.v0.to(device), self.e1.to(device), self.e2.to(device),
            self.normal.to(device), self.material_id.to(device),
            self.area.to(device))


@dataclasses.dataclass
class MaterialTable:
    """SoA material table (Primitives.hpp:18-27)."""

    albedo: Vec3  # [M]
    f0: Vec3
    f80: Vec3
    emission: Vec3
    transmission: Vec3
    roughness: torch.Tensor  # [M]
    ior_minus_one: torch.Tensor  # [M]

    @property
    def count(self) -> int:
        return self.roughness.shape[0]

    def to(self, device) -> "MaterialTable":
        return MaterialTable(*(getattr(self, k).to(device)
                               for k in _MATERIAL_FIELDS))


@dataclasses.dataclass
class Sky:
    """Equirectangular environment (Primitives.hpp:29-47): flattened [H*W]
    planes multiplied by the ambient tint. A 1x1 white texture gives a
    constant sky through the same lookup."""

    ambient: Vec3  # 0-d components
    hdri_r: torch.Tensor  # [H*W]
    hdri_g: torch.Tensor
    hdri_b: torch.Tensor
    width: int
    height: int

    @staticmethod
    def constant(ambient=(0.0, 0.0, 0.0), device=None) -> "Sky":
        one = torch.ones((1,), dtype=torch.float32, device=device)
        return Sky(Vec3.splat(ambient, device), one, one, one, 1, 1)

    @staticmethod
    def from_image(img: np.ndarray, ambient=(1.0, 1.0, 1.0),
                   device=None) -> "Sky":
        """img: [H, W, >=3] float32 equirect radiance map."""
        h, w = img.shape[:2]
        img = np.asarray(img, np.float32)
        planes = [torch.from_numpy(np.ascontiguousarray(
            img[..., k].reshape(-1))).to(device) for k in range(3)]
        return Sky(Vec3.splat(ambient, device), *planes, w, h)

    def sample(self, d: Vec3) -> Vec3:
        """Nearest-texel equirect lookup (Primitives.hpp:35-46). The texel
        coordinates contract as XLA contracts them in the JAX package
        (0.5 + c * atan2 and 0.5 - c * asin, each one fma), with atan2 and
        asin correctly rounded (``core/fp.py``); a 1x1 map has one texel
        whatever the direction."""
        if self.width == 1 and self.height == 1:
            flat = torch.zeros(d.x.shape, dtype=torch.int64,
                               device=d.x.device)
        else:
            u = fma(fp.atan2(d.z, d.x), float(np.float32(0.5 / np.pi)), 0.5)
            v = fma(fp.asin(torch.clamp(d.y, -1.0, 1.0)),
                    -float(np.float32(1.0 / np.pi)), 0.5)
            ix = torch.clamp((u * float(self.width - 1)).to(torch.int64), 0,
                             self.width - 1)
            iy = torch.clamp((v * float(self.height - 1)).to(torch.int64), 0,
                             self.height - 1)
            flat = iy * self.width + ix
        return Vec3(
            self.hdri_r[flat] * self.ambient.x,
            self.hdri_g[flat] * self.ambient.y,
            self.hdri_b[flat] * self.ambient.z,
        )

    def has_ambient(self) -> torch.Tensor:
        """max(ambient) > 0 gate (Renderer.hpp:79), a 0-d bool tensor."""
        return self.ambient.max_component() > 0.0

    def to(self, device) -> "Sky":
        return Sky(self.ambient.to(device), self.hdri_r.to(device),
                   self.hdri_g.to(device), self.hdri_b.to(device),
                   self.width, self.height)


@dataclasses.dataclass
class Camera:
    """Pinhole camera (Camera.hpp:5-89) as 0-d float32 tensors;
    ``z = half_height * inv_half_tan``, ``inv_half_tan = -2/sensor * focal``."""

    pos: Vec3
    orient: Quat  # (x, y, z, w)
    half_width: torch.Tensor
    half_height: torch.Tensor
    z: torch.Tensor
    exposure: torch.Tensor
    aperture_radius: torch.Tensor  # world units; 0 => pinhole
    focus_distance: torch.Tensor

    SENSOR_SIZE_MM = 24.0

    @staticmethod
    def create(eye, forward, width: int, height: int,
               focal_length: float = 50.0, focus_distance: float = 1.0,
               f_number: float = 16.0, exposure: float = 1.0,
               aperture_world_radius: Optional[float] = None,
               device=None) -> "Camera":
        orient = quat_look_at(np.asarray(forward, np.float64),
                              np.array([0.0, 1.0, 0.0]))
        inv_half_tan = (-2.0 / Camera.SENSOR_SIZE_MM) * focal_length
        if aperture_world_radius is None:
            # focal/(2N) is in mm (Camera.hpp:17-19); to world (meter) units
            aperture_world_radius = focal_length / (2.0 * f_number) * 1e-3
        return Camera(
            pos=Vec3(*(_f32(c, device) for c in eye)),
            orient=Quat(*(_f32(c, device) for c in orient)),
            half_width=_f32(width * 0.5, device),
            half_height=_f32(height * 0.5, device),
            z=_f32(height * 0.5 * inv_half_tan, device),
            exposure=_f32(exposure, device),
            aperture_radius=_f32(aperture_world_radius, device),
            focus_distance=_f32(focus_distance, device),
        )

    def resized(self, width: int, height: int) -> "Camera":
        inv_half_tan = self.z / self.half_height
        dev = self.z.device
        return dataclasses.replace(
            self,
            half_width=_f32(width * 0.5, dev),
            half_height=_f32(height * 0.5, dev),
            z=_f32(height * 0.5, dev) * inv_half_tan,
        )

    def to(self, device) -> "Camera":
        return Camera(self.pos.to(device), self.orient.to(device),
                      *(getattr(self, k).to(device) for k in (
                          "half_width", "half_height", "z", "exposure",
                          "aperture_radius", "focus_distance")))


def quat_look_at(forward, up):
    """glm::quatLookAt(normalize(forward), up) on the host -> (x, y, z, w)
    (Camera.hpp:48-49), in float64 as in the JAX package."""
    f = np.asarray(forward, np.float64)
    f = f / np.linalg.norm(f)
    z = -f
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.stack([x, y, z], axis=1)  # columns
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        qx = (m[2, 1] - m[1, 2]) / s
        qy = (m[0, 2] - m[2, 0]) / s
        qz = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        qx = 0.25 * s
        qy = (m[0, 1] + m[1, 0]) / s
        qz = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        qx = (m[0, 1] + m[1, 0]) / s
        qy = 0.25 * s
        qz = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        qx = (m[0, 2] + m[2, 0]) / s
        qy = (m[1, 2] + m[2, 1]) / s
        qz = 0.25 * s
    return (qx, qy, qz, w)


def build_light_list(material_ids: np.ndarray, emission: np.ndarray) -> np.ndarray:
    """Host-side LightingAcceleration (Scene.hpp:12-16): prims whose material
    has nonzero emission (dot(em, em) > 0)."""
    em = emission[material_ids]
    mask = (em * em).sum(-1) > 0.0
    return np.nonzero(mask)[0].astype(np.int32)


@dataclasses.dataclass
class LightAlias:
    """O(1) light selection over static power weights (Vose's alias
    method), for ``light_sampling='alias'``: w_i = max emission x size (r^2
    for a sphere light, area for a triangle light), the distance-free
    numerator of the 'power' weights. ``table`` rows are (prob, alias,
    pdf_bin, pdf_alias): the alias bin's pdf sits beside its own, so the pdf
    of the selected light needs no second gather; alias indices ride as
    float32 (exact below 2^24 lights). ``sphere_pdf`` / ``tri_pdf`` give each
    prim's selection pdf, 0 for a prim that is no light."""

    table: torch.Tensor  # [L, 4] float32
    sphere_pdf: torch.Tensor  # [P] float32
    tri_pdf: Optional[torch.Tensor] = None  # [T] float32

    def to(self, device) -> "LightAlias":
        return LightAlias(self.table.to(device), self.sphere_pdf.to(device),
                          None if self.tri_pdf is None
                          else self.tri_pdf.to(device))


def _vose_alias(p: np.ndarray):
    """Vose's alias-table construction from a normalized pmf [L], operation
    for operation the JAX package's (its pops from Python lists make the
    table depend on that order)."""
    n = p.size
    prob = (p * n).astype(np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if prob[i] < 1.0]
    large = [i for i in range(n) if prob[i] >= 1.0]
    while small and large:
        s, g = small.pop(), large.pop()
        alias[s] = g
        prob[g] -= 1.0 - prob[s]
        (small if prob[g] < 1.0 else large).append(g)
    for i in small + large:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def light_alias_arrays(arrays: dict) -> Optional[dict]:
    """The ``light_alias_*`` arrays of a scene from its flat arrays
    (``Scene.to_numpy``'s layout), built on the host in float64 as the JAX
    package's ``build_light_alias``; None for a scene without lights."""
    lights = np.asarray(arrays["lights"])
    tri_lights = arrays.get("tri_lights")
    n_s = lights.shape[0]
    n_t = 0 if tri_lights is None else np.asarray(tri_lights).shape[0]
    total = n_s + n_t
    if total == 0:
        return None
    em = np.asarray(arrays["material_emission"], np.float32).max(axis=1)
    weights = []
    if n_s > 0:
        mid = np.asarray(arrays["sphere_material_id"])[lights]
        weights.append(em[mid] * np.asarray(arrays["sphere_radius_sq"],
                                            np.float32)[lights])
    if n_t > 0:
        tl = np.asarray(tri_lights)
        mid = np.asarray(arrays["tri_material_id"])[tl]
        weights.append(em[mid] * np.asarray(arrays["tri_area"],
                                            np.float32)[tl])
    w = np.concatenate(weights).astype(np.float64)
    ws = w.sum()
    p = (w / ws) if ws > 0 else np.full(total, 1.0 / total)
    prob, alias = _vose_alias(p)
    p32 = p.astype(np.float32)
    out = {
        "light_alias_table": np.stack(
            [prob, alias.astype(np.float32), p32, p32[alias]], axis=1),
        "light_alias_sphere_pdf": np.zeros(
            np.asarray(arrays["sphere_radius_sq"]).shape[0], np.float32),
    }
    if n_s > 0:
        out["light_alias_sphere_pdf"][lights] = p32[:n_s]
    if "tri_area" in arrays:
        tri_pdf = np.zeros(np.asarray(arrays["tri_area"]).shape[0],
                           np.float32)
        if n_t > 0:
            tri_pdf[np.asarray(tri_lights)] = p32[n_s:]
        out["light_alias_tri_pdf"] = tri_pdf
    return out


_MATERIAL_FIELDS = ("albedo", "f0", "f80", "emission", "transmission",
                    "roughness", "ior_minus_one")
_TRIANGLE_VECS = ("v0", "e1", "e2", "normal")
# the acceleration tables a scene may carry beside its clusters, with the
# class whose from_numpy reads each
_ACCEL = {"sphere_bvh": BVHArrays, "tri_bvh": BVHArrays,
          "sphere_grid": UniformGrid, "tri_grid": UniformGrid}
_CAMERA_SCALARS = ("half_width", "half_height", "z", "exposure",
                   "aperture_radius", "focus_distance")


@dataclasses.dataclass
class Scene:
    """Full scene aggregate (Scene.hpp:19-26). ``lights`` is the NEE light
    list of emissive spheres and ``tri_lights`` that of emissive triangles
    (int32 indices into their own geometry); a light's index in NEE counts
    the sphere lights first."""

    spheres: SphereGeometry
    materials: MaterialTable
    lights: torch.Tensor  # [L] int32
    camera: Camera
    sky: Sky
    triangles: Optional[TriangleGeometry] = None
    tri_lights: Optional[torch.Tensor] = None  # [L2] int32
    sphere_clusters: Optional[ClusteredPrims] = None  # scene.accel
    tri_clusters: Optional[ClusteredPrims] = None
    light_alias: Optional[LightAlias] = None  # 'alias' light selection
    sphere_bvh: Optional[BVHArrays] = None  # scene.accel.with_bvh
    tri_bvh: Optional[BVHArrays] = None
    sphere_grid: Optional[UniformGrid] = None  # scene.accel.with_grid
    tri_grid: Optional[UniformGrid] = None

    @property
    def num_lights(self) -> int:
        """Sphere lights, as in the JAX package; NEE adds the triangle
        lights (``num_tri_lights``) to its count."""
        return int(self.lights.shape[0])

    @property
    def num_tri_lights(self) -> int:
        return 0 if self.tri_lights is None else int(self.tri_lights.shape[0])

    @property
    def num_prims(self) -> int:
        """Spheres plus triangles."""
        tri = self.triangles
        return self.spheres.count + (0 if tri is None else tri.count)

    @property
    def device(self) -> torch.device:
        return self.spheres.radius_sq.device

    def to(self, device) -> "Scene":
        def moved(a):
            return None if a is None else a.to(device)

        return Scene(self.spheres.to(device), self.materials.to(device),
                     self.lights.to(device), self.camera.to(device),
                     self.sky.to(device), triangles=moved(self.triangles),
                     tri_lights=moved(self.tri_lights),
                     sphere_clusters=moved(self.sphere_clusters),
                     tri_clusters=moved(self.tri_clusters),
                     light_alias=moved(self.light_alias),
                     **{k: moved(getattr(self, k)) for k in _ACCEL})

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "Scene":
        """Build a scene from the flat arrays of ``to_numpy``'s layout:
        ``sphere_center`` [P,3], ``sphere_radius_sq`` [P],
        ``sphere_material_id`` [P] int32, ``material_<field>`` ([M,3] or
        [M]), ``lights`` [L] int32, ``sky_ambient`` [3], ``sky_hdri``
        [H*W,3], ``sky_width``/``sky_height``, ``camera_pos`` [3],
        ``camera_orient`` [4] (x,y,z,w) and the ``camera_<scalar>`` fields;
        for a scene with triangles ``tri_v0``, ``tri_e1``, ``tri_e2``,
        ``tri_normal`` [T,3], ``tri_area`` [T], ``tri_material_id`` [T] int32
        and ``tri_lights`` [L2] int32; optionally ``sphere_clusters`` and
        ``tri_clusters``, the dicts ``ClusteredPrims.from_numpy`` reads,
        ``sphere_bvh`` / ``tri_bvh`` (``BVHArrays.from_numpy``'s dicts),
        ``sphere_grid`` / ``tri_grid`` (``UniformGrid.from_numpy``'s), and
        the alias table ``light_alias_table`` [L, 4],
        ``light_alias_sphere_pdf`` [P] and, with triangles,
        ``light_alias_tri_pdf`` [T] (``light_alias_arrays``; without them
        the scene has no ``light_alias``). Values are taken bit for bit."""
        t = functools.partial(_tensor, arrays, device=device)
        vec = functools.partial(_vec, arrays, device=device)
        hdri = t("sky_hdri")
        sky = Sky(vec("sky_ambient"), *(hdri[:, k].contiguous() for k in range(3)),
                  int(arrays["sky_width"]), int(arrays["sky_height"]))
        orient = t("camera_orient")
        camera = Camera(vec("camera_pos"), Quat(*(orient[k] for k in range(4))),
                        *(t(f"camera_{k}") for k in _CAMERA_SCALARS))

        def clusters(key):
            cp = arrays.get(key)
            return None if cp is None else ClusteredPrims.from_numpy(cp, device)

        return Scene(*_geometry(arrays, device), camera, sky,
                     **_triangles(arrays, device),
                     sphere_clusters=clusters("sphere_clusters"),
                     tri_clusters=clusters("tri_clusters"),
                     light_alias=_light_alias(arrays, device),
                     **{k: None if arrays.get(k) is None
                        else cls.from_numpy(arrays[k], device)
                        for k, cls in _ACCEL.items()})

    def to_numpy(self) -> dict:
        """The flat-array layout ``from_numpy`` reads."""
        out = {
            "sphere_center": _vec_np(self.spheres.center),
            "sphere_radius_sq": self.spheres.radius_sq.cpu().numpy(),
            "sphere_material_id": self.spheres.material_id.cpu().numpy(),
            "lights": self.lights.cpu().numpy(),
            "sky_ambient": _vec_np(self.sky.ambient),
            "sky_hdri": np.stack([c.cpu().numpy() for c in (
                self.sky.hdri_r, self.sky.hdri_g, self.sky.hdri_b)], axis=-1),
            "sky_width": self.sky.width,
            "sky_height": self.sky.height,
            "camera_pos": _vec_np(self.camera.pos),
            "camera_orient": np.stack([c.cpu().numpy() for c in self.camera.orient]),
        }
        for k in _MATERIAL_FIELDS:
            v = getattr(self.materials, k)
            out[f"material_{k}"] = (_vec_np(v) if isinstance(v, Vec3)
                                    else v.cpu().numpy())
        for k in _CAMERA_SCALARS:
            out[f"camera_{k}"] = getattr(self.camera, k).cpu().numpy()
        tri = self.triangles
        if tri is not None:
            for k in _TRIANGLE_VECS:
                out[f"tri_{k}"] = _vec_np(getattr(tri, k))
            out["tri_area"] = tri.area.cpu().numpy()
            out["tri_material_id"] = tri.material_id.cpu().numpy()
            out["tri_lights"] = self.tri_lights.cpu().numpy()
        for key in ("sphere_clusters", "tri_clusters", *_ACCEL):
            if getattr(self, key) is not None:
                out[key] = getattr(self, key).to_numpy()
        la = self.light_alias
        if la is not None:
            out["light_alias_table"] = la.table.cpu().numpy()
            out["light_alias_sphere_pdf"] = la.sphere_pdf.cpu().numpy()
            if la.tri_pdf is not None:
                out["light_alias_tri_pdf"] = la.tri_pdf.cpu().numpy()
        return out


def make_scene(centers, radii, material_ids, materials: dict, camera: Camera,
               sky: Sky, triangles: Optional[dict] = None) -> Scene:
    """Host-side scene assembly from numpy arrays (the JAX package's
    ``make_scene``). materials: albedo, f0, f80, emission, transmission
    ([M,3]) and roughness, ior_minus_one ([M]). triangles: v0, v1, v2 ([T,3])
    and material_id ([T]); edges, unit normals and areas are made here in
    numpy float32, as there, and the scene carries its alias table
    (``light_alias_arrays``) as the JAX builder's does."""
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    material_ids = np.asarray(material_ids, np.int32)
    m = {k: np.asarray(v, np.float32) for k, v in materials.items()}
    arrays = {
        "sphere_center": centers,
        "sphere_radius_sq": radii * radii,
        "sphere_material_id": material_ids,
        "lights": build_light_list(material_ids, m["emission"]),
    }
    arrays.update({f"material_{k}": m[k] for k in _MATERIAL_FIELDS})
    if triangles is not None:
        v0 = np.asarray(triangles["v0"], np.float32)
        e1 = np.asarray(triangles["v1"], np.float32) - v0
        e2 = np.asarray(triangles["v2"], np.float32) - v0
        tmid = np.asarray(triangles["material_id"], np.int32)
        n = np.cross(e1, e2)
        area2 = np.linalg.norm(n, axis=-1)
        arrays.update({
            "tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
            "tri_normal": n / np.maximum(area2[:, None], 1e-20),
            "tri_area": 0.5 * area2, "tri_material_id": tmid,
            "tri_lights": build_light_list(tmid, m["emission"])})
    alias = light_alias_arrays(arrays)
    if alias is not None:
        arrays.update(alias)
    device = camera.z.device
    return Scene(*_geometry(arrays, device), camera=camera, sky=sky,
                 **_triangles(arrays, device),
                 light_alias=_light_alias(arrays, device))


def _tensor(arrays, key, dtype=np.float32, device=None) -> torch.Tensor:
    a = np.array(arrays[key], dtype=dtype, order="C")  # a writable copy
    return torch.from_numpy(a).to(device)


def _vec(arrays, key, device=None) -> Vec3:
    a = _tensor(arrays, key, device=device)
    return Vec3(*(a[..., k].contiguous() for k in range(3)))


def _geometry(arrays, device):
    """(SphereGeometry, MaterialTable, lights) from the flat arrays."""
    t = functools.partial(_tensor, arrays, device=device)
    vec = functools.partial(_vec, arrays, device=device)
    spheres = SphereGeometry(vec("sphere_center"), t("sphere_radius_sq"),
                             t("sphere_material_id", np.int32))
    mats = MaterialTable(*(
        t(f"material_{k}") if k in ("roughness", "ior_minus_one")
        else vec(f"material_{k}") for k in _MATERIAL_FIELDS))
    return spheres, mats, t("lights", np.int32)


def _triangles(arrays, device) -> dict:
    """The ``triangles`` and ``tri_lights`` fields of a Scene from the flat
    arrays; both None for a scene without triangles."""
    if "tri_v0" not in arrays:
        return {"triangles": None, "tri_lights": None}
    t = functools.partial(_tensor, arrays, device=device)
    tri = TriangleGeometry(
        *(_vec(arrays, f"tri_{k}", device=device) for k in _TRIANGLE_VECS),
        material_id=t("tri_material_id", np.int32), area=t("tri_area"))
    return {"triangles": tri, "tri_lights": t("tri_lights", np.int32)}


def _light_alias(arrays, device) -> Optional[LightAlias]:
    """The scene's LightAlias from the flat arrays, None without them."""
    if "light_alias_table" not in arrays:
        return None
    t = functools.partial(_tensor, arrays, device=device)
    return LightAlias(t("light_alias_table"), t("light_alias_sphere_pdf"),
                      t("light_alias_tri_pdf") if "light_alias_tri_pdf"
                      in arrays else None)
