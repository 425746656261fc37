"""Scene inputs from a configuration file (``portbench/configs/<name>.json``).

One builder makes the arrays that both sides get: the system under test
reads them through ``Scene.from_numpy`` (its flat layout, returned by
``port_arrays``), the reference through ``reference.pathtrace.make_scene``.
Geometry generators are copies of the ones the configurations' sources
use, so the arrays equal those sources' (a test holds them to the port's
own builders).

A configuration's ``"meshes"`` entries are triangles, each found by its
``kind`` in ``MESHES``: a generated mesh (``displaced_uv_sphere``,
``displaced_icosphere``: the generator's arguments and one ``material``),
or explicit ``rows``, each with its own ``material`` (``triangles``: ``v0``,
``v1``, ``v2``; ``quads``: ``v0`` to ``v3``, split into (v0, v1, v2) and
(v0, v2, v3) as the port's scene builder splits a quad). A triangle whose
material emits is a triangle light.
"""
from __future__ import annotations

import numpy as np

SENSOR_SIZE_MM = 24.0
# the keys of a configuration that ``build`` reads
KEYS = frozenset({"materials", "spheres", "meshes", "camera", "sky"})


def quat_look_at(forward, up=(0.0, 1.0, 0.0)):
    """glm::quatLookAt(normalize(forward), up) in float64 -> (x, y, z, w)."""
    f = np.asarray(forward, np.float64)
    f = f / np.linalg.norm(f)
    z = -f
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.stack([x, y, z], axis=1)
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return ((m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                (m[1, 0] - m[0, 1]) / s, 0.25 * s)
    if m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        return (0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s,
                (m[2, 1] - m[1, 2]) / s)
    if m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        return ((m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s,
                (m[0, 2] - m[2, 0]) / s)
    s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
    return ((m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s,
            (m[1, 0] - m[0, 1]) / s)


def _fbm(p: np.ndarray, octaves: int = 5, seed: int = 7) -> np.ndarray:
    """Sum of randomly oriented sinusoids on unit-sphere points."""
    g = np.random.default_rng(seed)
    out = np.zeros(p.shape[0])
    amp, freq = 1.0, 1.5
    for _ in range(octaves):
        for _k in range(3):
            dirn = g.normal(size=3)
            dirn /= np.linalg.norm(dirn)
            phase = g.uniform(0, 2 * np.pi)
            out += amp * np.sin(freq * (p @ dirn) * np.pi + phase)
        amp *= 0.45
        freq *= 2.1
    return out / 3.0


def icosahedron():
    """The unit icosahedron: (vertices [12, 3] float64, faces [20, 3])."""
    phi = (1 + np.sqrt(5)) / 2
    v = np.array([[-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
                  [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
                  [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    return v, f


def subdivide(v, f):
    """Midpoint subdivision on the unit sphere (4x triangles)."""
    cache = {}
    v = list(map(tuple, v))

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = (np.asarray(v[a]) + np.asarray(v[b])) / 2
            m /= np.linalg.norm(m)
            cache[key] = len(v)
            v.append(tuple(m))
        return cache[key]

    nf = []
    for a, b, c in f:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(v, np.float64), np.asarray(nf, np.int64)


def displaced_icosphere(subdivisions: int, displacement: float, seed: int):
    """An icosphere of 20 * 4^subdivisions triangles under the fBm
    displacement: (vertices [V, 3] float32, faces [F, 3] int64)."""
    v, f = icosahedron()
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    v = v * (1.0 + displacement * _fbm(v, seed=seed)[:, None])
    return v.astype(np.float32), f


def displaced_uv_sphere(n_u: int, n_v: int, displacement: float, seed: int):
    """A UV sphere of 2 * n_u * n_v triangles under an fBm displacement:
    (vertices [V, 3] float32, faces [F, 3] int64)."""
    theta = np.linspace(1e-3, np.pi - 1e-3, n_v + 1)
    phi = np.linspace(0.0, 2 * np.pi, n_u, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    v = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                  np.sin(tt) * np.sin(pp)], axis=-1).reshape(-1, 3)
    idx = np.arange((n_v + 1) * n_u).reshape(n_v + 1, n_u)
    right = np.roll(idx, -1, axis=1)
    a, b = idx[:-1], idx[1:]
    c, d = right[:-1], right[1:]
    f = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                        np.stack([c, b, d], -1).reshape(-1, 3)]).astype(
                            np.int64)
    v = v * (1.0 + displacement * _fbm(v, seed=seed)[:, None])
    return v.astype(np.float32), f


_MATERIAL_DEFAULTS = {"albedo": (0, 0, 0), "f0": (0, 0, 0), "f80": (1, 1, 1),
                      "emission": (0, 0, 0), "transmission": (0, 0, 0),
                      "roughness": 0.0, "ior_minus_one": 0.0}


def _camera(cam: dict, width: int, height: int) -> dict:
    focal = float(cam.get("focal_length", 50.0))
    f_number = float(cam.get("f_number", 16.0))
    inv_half_tan = (-2.0 / SENSOR_SIZE_MM) * focal
    return {
        "pos": np.asarray(cam["eye"], np.float32),
        "orient": np.asarray(quat_look_at(cam["forward"]), np.float32),
        "half_width": np.float32(width * 0.5),
        "half_height": np.float32(height * 0.5),
        "z": np.float32(height * 0.5 * inv_half_tan),
        "exposure": np.float32(cam.get("exposure", 1.0)),
        "aperture_radius": np.float32(focal / (2.0 * f_number) * 1e-3),
        "focus_distance": np.float32(cam.get("focus_distance", 1.0)),
    }


def _generated(generator):
    """A mesh kind made by `generator` (the entry's other keys are its
    arguments) in the entry's one material."""
    def triangles(mesh: dict):
        args = {k: v for k, v in mesh.items() if k not in ("kind",
                                                           "material")}
        verts, faces = generator(**args)
        return (verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]],
                np.full(faces.shape[0], mesh["material"], np.int32))
    return triangles


def _rows(*corners):
    """A mesh kind of explicit rows of `corners` vertices and a material,
    each row split into the fan (0, i, i + 1)."""
    def triangles(mesh: dict):
        fan = [(0, i, i + 1) for i in range(1, len(corners) - 1)]
        rows = mesh["rows"]
        tris = [[row[corners[i]] for i in tri] for row in rows for tri in fan]
        v = np.asarray(tris, np.float32).reshape(-1, 3, 3)
        mats = np.asarray([row["material"] for row in rows for _ in fan],
                          np.int32)
        return v[:, 0], v[:, 1], v[:, 2], mats
    return triangles


MESHES = {"displaced_uv_sphere": _generated(displaced_uv_sphere),
          "displaced_icosphere": _generated(displaced_icosphere),
          "triangles": _rows("v0", "v1", "v2"),
          "quads": _rows("v0", "v1", "v2", "v3")}


def _triangles(config: dict):
    """(v0, v1, v2 [T, 3] float32, material id [T] int32) of the meshes."""
    parts = []
    for mesh in config.get("meshes", []):
        if mesh["kind"] not in MESHES:
            raise ValueError(f"no mesh kind {mesh['kind']!r}; the kinds are "
                             f"{sorted(MESHES)}")
        parts.append(MESHES[mesh["kind"]](mesh))
    if not parts:
        return None
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(4))


def build(config: dict, width: int, height: int) -> dict:
    """The scene inputs of `config` at width x height: spheres, materials,
    triangles (v0 and its edges, unit normals, areas), camera and sky, as
    numpy arrays in float32 (ids in int32)."""
    mats = [dict(_MATERIAL_DEFAULTS, **m) for m in config["materials"]]
    spheres = config["spheres"]
    out = {
        "sphere_center": np.asarray([s["center"] for s in spheres],
                                    np.float32).reshape(-1, 3),
        "sphere_material_id": np.asarray([s["material"] for s in spheres],
                                         np.int32),
        "sky_ambient": np.asarray(config["sky"], np.float32),
        "camera": _camera(config["camera"], width, height),
    }
    radii = np.asarray([s["radius"] for s in spheres], np.float32)
    out["sphere_radius_sq"] = radii * radii
    for k, v in _MATERIAL_DEFAULTS.items():
        out[f"material_{k}"] = np.asarray([m[k] for m in mats], np.float32)
        if isinstance(v, tuple):
            out[f"material_{k}"] = out[f"material_{k}"].reshape(-1, 3)
    tris = _triangles(config)
    if tris is None:
        tris = (np.zeros((0, 3), np.float32),) * 3 + (np.zeros(0, np.int32),)
    v0, v1, v2, tmid = tris
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    area2 = np.linalg.norm(n, axis=-1)
    out.update({"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
                "tri_normal": n / np.maximum(area2[:, None], 1e-20),
                "tri_area": 0.5 * area2, "tri_material_id": tmid})
    return out


def _light_list(material_ids, emission):
    em = emission[material_ids]
    return np.nonzero((em * em).sum(-1) > 0.0)[0].astype(np.int32)


def port_arrays(inputs: dict) -> dict:
    """The inputs in the flat layout of the port's ``Scene.from_numpy``."""
    out = {k: v for k, v in inputs.items()
           if not k.startswith(("camera", "tri_"))}
    out["lights"] = _light_list(inputs["sphere_material_id"],
                                inputs["material_emission"])
    out.update({"sky_hdri": np.ones((1, 3), np.float32), "sky_width": 1,
                "sky_height": 1})
    cam = inputs["camera"]
    out["camera_pos"] = cam["pos"]
    out["camera_orient"] = cam["orient"]
    for k in ("half_width", "half_height", "z", "exposure", "aperture_radius",
              "focus_distance"):
        out[f"camera_{k}"] = cam[k]
    if inputs["tri_material_id"].shape[0]:
        out.update({k: v for k, v in inputs.items() if k.startswith("tri_")})
        out["tri_lights"] = _light_list(inputs["tri_material_id"],
                                        inputs["material_emission"])
    return out

