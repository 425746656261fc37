"""Scene edits with selective invalidation, the port of the JAX package's
``scene/edit.py`` (the reference's UpdateTracker flow,
Application.cpp:335-358, 508-510): every edit ORs a ``SceneUpdate`` bit;
at commit

  * Geometry                      -> rebuild the BVH
  * Geometry | Material | Light   -> rebuild the NEE light lists
  * anything                      -> reset the accumulator.

An edit returns a new scene whose edited tensors are copies (clone, then
index-set), as the JAX package's ``.at[].set`` does: the scene it was given
is never written. ``needs_bvh`` rebuilds the BVH of a scene that carries
one (``scene.accel.with_bvh``, which reorders the prims again from their
current order, as the JAX package does); like the JAX package, a geometry
edit leaves a uniform grid and the cluster packs as they were (ROADMAP
queue 3).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..core.vec import Quat, Vec3
from .scene import (Camera, LightAlias, Scene, _f32, build_light_list,
                    light_alias_arrays)


class SceneUpdate(enum.IntFlag):
    """Application.cpp:335-341."""

    NULL = 0
    GEOMETRY = 1
    MATERIAL = 2
    LIGHT = 4
    AMBIENT = 8
    CAMERA = 16

    @property
    def needs_bvh(self) -> bool:
        return bool(self & SceneUpdate.GEOMETRY)

    @property
    def needs_light_list(self) -> bool:
        return bool(self & (SceneUpdate.GEOMETRY | SceneUpdate.MATERIAL
                            | SceneUpdate.LIGHT))


def _set(a: torch.Tensor, index: int, value) -> torch.Tensor:
    out = a.clone()
    out[index] = value
    return out


def _set_component(vec: Vec3, index: int, value) -> Vec3:
    return Vec3(*(_set(c, index, float(v)) for c, v in zip(vec, value)))


def set_sphere(scene: Scene, index: int, position=None, radius=None,
               material_id=None):
    """Edit one sphere (the scene editor's geometry panel,
    Application.cpp:463-471). Returns (scene, flags)."""
    spheres = scene.spheres
    flags = SceneUpdate.NULL
    if position is not None:
        spheres = dataclasses.replace(
            spheres, center=_set_component(spheres.center, index, position))
        flags |= SceneUpdate.GEOMETRY
    if radius is not None:
        # the square in float64, then stored as float32, as in the JAX
        # package
        spheres = dataclasses.replace(spheres, radius_sq=_set(
            spheres.radius_sq, index, float(radius * radius)))
        flags |= SceneUpdate.GEOMETRY
    if material_id is not None:
        spheres = dataclasses.replace(spheres, material_id=_set(
            spheres.material_id, index, int(material_id)))
        flags |= SceneUpdate.MATERIAL
    return dataclasses.replace(scene, spheres=spheres), flags


def set_material(scene: Scene, index: int, **fields):
    """Edit one material (Application.cpp:474-487). Vec3 fields: albedo,
    f0, f80, emission, transmission; scalars: roughness, ior_minus_one."""
    mats = scene.materials
    updates = {}
    for name, value in fields.items():
        cur = getattr(mats, name)
        updates[name] = (_set_component(cur, index, value)
                         if isinstance(cur, Vec3)
                         else _set(cur, index, float(value)))
    return (dataclasses.replace(
        scene, materials=dataclasses.replace(mats, **updates)),
        SceneUpdate.MATERIAL)


def set_ambient(scene: Scene, color):
    """Application.cpp:503."""
    sky = dataclasses.replace(scene.sky,
                              ambient=Vec3.splat(color, scene.device))
    return dataclasses.replace(scene, sky=sky), SceneUpdate.AMBIENT


def set_camera(scene: Scene, **fields):
    """Camera pose and lens edits (Application.cpp:413-417). Fields: pos
    (3,), focus_distance, aperture_radius, exposure, z."""
    dev = scene.device
    updates = {name: Vec3.splat(value, dev) if name == "pos"
               else _f32(value, dev) for name, value in fields.items()}
    return (dataclasses.replace(
        scene, camera=dataclasses.replace(scene.camera, **updates)),
        SceneUpdate.CAMERA)


def apply_invalidation(scene: Scene, flags: SceneUpdate) -> Scene:
    """End-of-frame rebuilds (Application.cpp:508-510): the light lists
    and the alias table, on the host as the JAX package builds them, put on
    the scene's device; then the BVH, where the scene has one."""
    if flags.needs_light_list:
        dev = scene.device
        emission = np.stack([c.cpu().numpy()
                             for c in scene.materials.emission], axis=1)

        def lights(material_id):
            return torch.from_numpy(build_light_list(
                material_id.cpu().numpy(), emission)).to(dev)

        scene = dataclasses.replace(scene,
                                    lights=lights(scene.spheres.material_id))
        if scene.triangles is not None:
            scene = dataclasses.replace(
                scene, tri_lights=lights(scene.triangles.material_id))
        arrays = {"lights": scene.lights, "tri_lights": scene.tri_lights,
                  "sphere_material_id": scene.spheres.material_id,
                  "sphere_radius_sq": scene.spheres.radius_sq}
        if scene.triangles is not None:
            arrays.update(tri_material_id=scene.triangles.material_id,
                          tri_area=scene.triangles.area)
        arrays = {k: v.cpu().numpy() for k, v in arrays.items()
                  if v is not None}
        arrays["material_emission"] = emission
        alias = light_alias_arrays(arrays)
        scene = dataclasses.replace(scene, light_alias=None if alias is None
                                    else LightAlias(*(
            torch.from_numpy(alias[k]).to(dev) if k in alias else None
            for k in ("light_alias_table", "light_alias_sphere_pdf",
                      "light_alias_tri_pdf"))))
    if flags.needs_bvh and scene.sphere_bvh is not None:
        from . import accel

        scene = accel.with_bvh(scene)
    return scene


class SceneEditor:
    """Stateful editor around a Renderer: the ImGui loop's edit -> track ->
    invalidate cycle."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.flags = SceneUpdate.NULL

    def edit(self, fn, *args, **kwargs):
        scene, flags = fn(self.renderer.scene, *args, **kwargs)
        self.renderer.scene = scene
        self.flags |= flags
        return self

    def commit(self):
        """Rebuild and reset, as at the end of UIRender
        (Application.cpp:508-510)."""
        if self.flags != SceneUpdate.NULL:
            self.renderer.scene = apply_invalidation(self.renderer.scene,
                                                     self.flags)
            self.renderer.reset_accumulator()
            self.flags = SceneUpdate.NULL
        return self


# Fly-camera motion (View::Rotate / View::Translate, Camera.hpp:47-59, and
# the WASDQE / mouse handling of Application.cpp:309-333): quaternion math
# on the host in float64, as in the JAX package; each returns (scene,
# CAMERA), and the caller resets the accumulator on commit as the reference
# does (:332).
def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _quat_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def _quat_from_euler(angles):
    """glm::quat{vec3 euler} (pitch, yaw, roll), XYZ intrinsic."""
    half = np.asarray(angles, np.float64) * 0.5
    cx, cy, cz = np.cos(half)
    sx, sy, sz = np.sin(half)
    return np.array([
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ])


def _camera_quat(scene):
    return np.array([float(c) for c in scene.camera.orient])


def rotate_camera_local(scene: Scene, angles):
    """View::Rotate (Camera.hpp:51-53): orient = conj(normalize(quat(angles)
    * conj(orient))); angles = (pitch, yaw, roll) in radians."""
    new = _quat_conj(_quat_mul(_quat_from_euler(angles),
                               _quat_conj(_camera_quat(scene))))
    new = new / np.linalg.norm(new)
    cam = dataclasses.replace(
        scene.camera, orient=Quat(*(_f32(v, scene.device) for v in new)))
    return dataclasses.replace(scene, camera=cam), SceneUpdate.CAMERA


def translate_camera_local(scene: Scene, local):
    """View::Translate (Camera.hpp:54-56): pos += orient * local."""
    q = _camera_quat(scene)
    v = np.asarray(local, np.float64)
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    world = v + q[3] * t + np.cross(qv, t)
    pos = np.array([float(c) for c in scene.camera.pos]) + world
    cam = dataclasses.replace(scene.camera,
                              pos=Vec3.splat(pos, scene.device))
    return dataclasses.replace(scene, camera=cam), SceneUpdate.CAMERA


def set_camera_lens(scene: Scene, width: int, height: int,
                    focal_length: float = None, f_number: float = None,
                    focus_distance: float = None, exposure: float = None):
    """Lens edits with the UpdateLens recompute (Camera.hpp:21-26 and the
    camera sliders, Application.cpp:413-417): focal length and f-number
    re-derive the projection z and the aperture radius."""
    cam = scene.camera
    dev = scene.device
    updates = {}
    cur_focal = float(-Camera.SENSOR_SIZE_MM / 2.0
                      * (cam.z / cam.half_height))
    focal = focal_length if focal_length is not None else cur_focal
    if focal_length is not None:
        inv_half_tan = (-2.0 / Camera.SENSOR_SIZE_MM) * focal
        updates["z"] = _f32(height * 0.5 * inv_half_tan, dev)
    if f_number is not None:
        updates["aperture_radius"] = _f32(focal / (2.0 * f_number) * 1e-3,
                                          dev)
    if focus_distance is not None:
        updates["focus_distance"] = _f32(focus_distance, dev)
    if exposure is not None:
        updates["exposure"] = _f32(exposure, dev)
    return (dataclasses.replace(scene,
                                camera=dataclasses.replace(cam, **updates)),
            SceneUpdate.CAMERA)
