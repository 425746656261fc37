"""Scene model on PyTorch tensors, the counterpart of the JAX package's
``scene/scene.py``: structure-of-arrays spheres and materials, the NEE light
list, an equirect sky and a pinhole camera.

The scene plays the part that weights play in a model port: ``Scene.from_numpy``
takes the flat numpy arrays of a scene (``Scene.to_numpy`` gives the same
layout), so both packages can render identical inputs. Builders assemble
scenes on the host; ``Scene.to(device)`` moves one to the card.

Triangle geometry is not part of this port slice: a scene that carries
triangles is refused with ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.vec import Quat, Vec3
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
        """Nearest-texel equirect lookup (Primitives.hpp:35-46)."""
        fw = float(self.width - 1)
        fh = float(self.height - 1)
        u = fw * (0.5 + (0.5 / np.pi) * torch.atan2(d.z, d.x))
        v = fh * (0.5 - (1.0 / np.pi) * torch.asin(torch.clamp(d.y, -1.0, 1.0)))
        ix = torch.clamp(u.to(torch.int64), 0, self.width - 1)
        iy = torch.clamp(v.to(torch.int64), 0, self.height - 1)
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


_MATERIAL_FIELDS = ("albedo", "f0", "f80", "emission", "transmission",
                    "roughness", "ior_minus_one")
_CAMERA_SCALARS = ("half_width", "half_height", "z", "exposure",
                   "aperture_radius", "focus_distance")


@dataclasses.dataclass
class Scene:
    """Full scene aggregate (Scene.hpp:19-26). ``lights`` is the NEE light
    list: int32 indices of emissive spheres."""

    spheres: SphereGeometry
    materials: MaterialTable
    lights: torch.Tensor  # [L] int32
    camera: Camera
    sky: Sky
    triangles: None = None  # triangle geometry is a later port slice
    sphere_clusters: Optional[ClusteredPrims] = None  # scene.accel

    @property
    def num_lights(self) -> int:
        return int(self.lights.shape[0])

    @property
    def device(self) -> torch.device:
        return self.spheres.radius_sq.device

    def to(self, device) -> "Scene":
        cp = self.sphere_clusters
        return Scene(self.spheres.to(device), self.materials.to(device),
                     self.lights.to(device), self.camera.to(device),
                     self.sky.to(device),
                     sphere_clusters=None if cp is None else cp.to(device))

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "Scene":
        """Build a scene from the flat arrays of ``to_numpy``'s layout:
        ``sphere_center`` [P,3], ``sphere_radius_sq`` [P],
        ``sphere_material_id`` [P] int32, ``material_<field>`` ([M,3] or
        [M]), ``lights`` [L] int32, ``sky_ambient`` [3], ``sky_hdri``
        [H*W,3], ``sky_width``/``sky_height``, ``camera_pos`` [3],
        ``camera_orient`` [4] (x,y,z,w) and the ``camera_<scalar>`` fields;
        optionally ``sphere_clusters``, the dict ``ClusteredPrims.from_numpy``
        reads. Values are taken bit for bit."""
        if any(k.startswith("tri") for k in arrays):
            raise NotImplementedError(
                "triangle geometry is not ported yet (sphere scenes only)")
        t = functools.partial(_tensor, arrays, device=device)
        vec = functools.partial(_vec, arrays, device=device)
        hdri = t("sky_hdri")
        sky = Sky(vec("sky_ambient"), *(hdri[:, k].contiguous() for k in range(3)),
                  int(arrays["sky_width"]), int(arrays["sky_height"]))
        orient = t("camera_orient")
        camera = Camera(vec("camera_pos"), Quat(*(orient[k] for k in range(4))),
                        *(t(f"camera_{k}") for k in _CAMERA_SCALARS))
        spheres, mats, lights = _geometry(arrays, device)
        cp = arrays.get("sphere_clusters")
        return Scene(spheres, mats, lights, camera, sky, sphere_clusters=(
            None if cp is None else ClusteredPrims.from_numpy(cp, device)))

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
        if self.sphere_clusters is not None:
            out["sphere_clusters"] = self.sphere_clusters.to_numpy()
        return out


def make_scene(centers, radii, material_ids, materials: dict, camera: Camera,
               sky: Sky, triangles: Optional[dict] = None) -> Scene:
    """Host-side scene assembly from numpy arrays (the JAX package's
    ``make_scene``). materials: albedo, f0, f80, emission, transmission
    ([M,3]) and roughness, ior_minus_one ([M])."""
    if triangles is not None:
        raise NotImplementedError(
            "triangle geometry is not ported yet (sphere scenes only)")
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
    return Scene(*_geometry(arrays, camera.z.device), camera=camera, sky=sky)


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
