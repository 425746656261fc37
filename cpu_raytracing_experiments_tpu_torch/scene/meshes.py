"""Procedural triangle meshes for the large scenes: the port's own copy of
the JAX package's ``scene/meshes.py`` (host numpy only; float64
intermediates, cast to float32 at the end, so the arrays equal that
package's exactly).

An organic mesh of a chosen triangle count: an icosphere subdivided k times,
or a UV sphere of an exact count, with a multi-octave displacement of the
surface (a smooth base shape with bumps). Also a minimal OBJ loader.
"""
from __future__ import annotations

import numpy as np


def icosahedron():
    phi = (1 + np.sqrt(5)) / 2
    v = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    return v, f


def subdivide(v, f):
    """Loop-style midpoint subdivision on the unit sphere (4x triangles)."""
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


def _fbm(p: np.ndarray, octaves: int = 5, seed: int = 7) -> np.ndarray:
    """Cheap value-noise fBm on unit-sphere points (gradient-free: sum of
    randomly oriented sinusoids — smooth, organic, deterministic)."""
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


def displaced_icosphere(subdivisions: int = 6, displacement: float = 0.15, seed: int = 7):
    """Organic test mesh: 20 * 4^k triangles (k=6 -> 81,920; k=7 -> 327,680).
    Returns (vertices [V,3] f32, faces [F,3] i64)."""
    v, f = icosahedron()
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    bump = _fbm(v, seed=seed)
    v = v * (1.0 + displacement * bump[:, None])
    return v.astype(np.float32), f


def displaced_uv_sphere(n_u: int = 224, n_v: int = 224,
                        displacement: float = 0.15, seed: int = 7):
    """Exact-count organic mesh: a UV sphere of 2 * n_u * n_v triangles with
    the same fBm displacement as displaced_icosphere. 224x224 gives 100,352
    tris — use it when a config demands a specific triangle count (BASELINE
    config 5: ~100k)."""
    theta = np.linspace(1e-3, np.pi - 1e-3, n_v + 1)
    phi = np.linspace(0.0, 2 * np.pi, n_u, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")  # [n_v+1, n_u]
    v = np.stack(
        [np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], axis=-1
    ).reshape(-1, 3)
    idx = np.arange((n_v + 1) * n_u).reshape(n_v + 1, n_u)
    right = np.roll(idx, -1, axis=1)
    a, b = idx[:-1], idx[1:]
    c, d = right[:-1], right[1:]
    f1 = np.stack([a, b, c], axis=-1).reshape(-1, 3)
    f2 = np.stack([c, b, d], axis=-1).reshape(-1, 3)
    f = np.concatenate([f1, f2], axis=0).astype(np.int64)
    bump = _fbm(v, seed=seed)
    v = v * (1.0 + displacement * bump[:, None])
    return v.astype(np.float32), f


def load_obj(path):
    """Minimal OBJ loader: v / f records, triangulates fans."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)


def mesh_to_triangles(verts: np.ndarray, faces: np.ndarray, material_id: int):
    """Expand an indexed mesh to the triangle-soup dict make_scene expects."""
    return {
        "v0": verts[faces[:, 0]],
        "v1": verts[faces[:, 1]],
        "v2": verts[faces[:, 2]],
        "material_id": np.full(faces.shape[0], material_id, np.int32),
    }
