"""The yardstick of the benchmark: a plain PyTorch path tracer with the
semantics of the reference renderer (Borx25/CPU-Raytracing-experiments:
Renderer.hpp's bounce loop, Sampling.hpp, Random.hpp) for the knobs the
cells use: a pinhole camera, jittered or stratified, several samples a
pixel; spheres and triangles; lambertian shading; next-event estimation of
sphere and triangle lights picked uniformly, with MIS (power heuristic) and
a shadow ray; emissive hits with MIS; Russian roulette; a constant sky; the
median-of-means buckets and the ACES resolve.

It imports nothing of the system under test. It takes the scene as the
arrays that the benchmark builds from a configuration file
(``portbench/scenes.py``) and derives everything else itself: triangle
planes, the bounding groups that cull triangle tests, the light lists.

It is the reference of every configuration that names none (a
configuration's ``"reference"`` names a module of this folder, found as
``run.reference`` finds it). Such a module exposes ``policy(port_policy)``,
``make_scene(inputs, device, dtype)``, ``buckets(scene, policy, pixels,
first_pass, n_passes, width)`` and ``resolve(buckets, accumulations, spp,
exposure)``, as this one does; it may import this one's helpers (the RNG,
intersection, the estimator) and never the system under test.
Every float is computed in one dtype (`dtype`): float32 for the check,
bfloat16 for its control. Integer work (the counter RNG) is exact in
int64. Products and sums are rounded one by one, as PyTorch rounds them,
but where a path is sensitive to rounding: there the multiply-adds that
the reference renderer's compiler fuses are fused (the sphere tests, the
light sample's distance, the hit point and its offset), and square roots,
reciprocal roots, sines and cosines are correctly rounded. A path whose
decision still lies within rounding of its threshold can end otherwise
than in the system under test; the check's limits are set from how often
that happens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MASK = 0xFFFFFFFF
FLT_EPSILON = 1.1920928955078125e-07
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
GOLDEN = 0.6180339887498949
GROUP = 64  # triangles in a culling group (the reference's own choice)


# --------------------------------------------------------------------------
# The counter RNG (Random.hpp): u32 values held in int64
# --------------------------------------------------------------------------
def mul32(a, c: int):
    lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK


def hash_2d(x, y):
    m = 0x41C64E6D
    qx = mul32((x >> 1) ^ y, m)
    qy = mul32((y >> 1) ^ x, m)
    return mul32(qx ^ (qy >> 3), m)


def hash_u32(i):
    i = i & MASK
    i = i ^ (i >> 16)
    i = mul32(i, 0x21F0AAAD)
    i = i ^ (i >> 15)
    i = mul32(i, 0xD35A2D97)
    i = i ^ (i >> 15)
    return i ^ 0xE6FE3BEB


def bitreverse32(x):
    x = x & MASK
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & MASK) | (x >> 16)


def unit(bits, dtype):
    return bits.to(dtype) * (2.0 ** -32)


def draws(state, n: int, dtype):
    """`n` unit floats from a PCG site state (Random.hpp:10-34)."""
    out = []
    for _ in range(n):
        word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
        out.append(unit((word >> 22) ^ word, dtype))
        state = (mul32(state, 747796405) + 2891336453) & MASK
    return out


# --------------------------------------------------------------------------
# Vectors as [N, 3] tensors
# --------------------------------------------------------------------------
def dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def fma(a, b, c):
    """a * b + c rounded once to the dtype of `a` (through float64, which
    holds the product exactly for float32 and narrower operands)."""
    dt = a.dtype
    return (a.double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).to(dt)


def _f64(fn):
    def rounded(x):
        return fn(x.double()).to(x.dtype)
    rounded.__doc__ = f"torch.{fn.__name__} correctly rounded to the dtype."
    return rounded


sqrt, rsqrt, sin, cos = (_f64(f) for f in (torch.sqrt, torch.rsqrt, torch.sin,
                                           torch.cos))


def dot_fused(a, b):
    """a . b as a chain of fused multiply-adds, fma(az, bz, fma(ax, bx,
    ay * by)), the contraction the reference's compiler makes."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 0], b[..., 0],
                                        a[..., 1] * b[..., 1]))


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v * rsqrt(torch.clamp_min(dot(v, v), 1e-30))[..., None]


def tangent_space(n):
    """Quaternion (x, y, w; z = 0) turning +Z onto n (Sampling.hpp:150)."""
    degenerate = n[:, 2] < (-1.0 + 1.1920929e-7)
    s = sqrt(torch.clamp_min(2.0 * (n[:, 2] + 1.0), 1e-30))
    inv = 1.0 / s
    qx = torch.where(degenerate, 0.0, -n[:, 1] * inv)
    qy = torch.where(degenerate, 1.0, n[:, 0] * inv)
    qw = torch.where(degenerate, 0.0, s * 0.5)
    return qx, qy, qw


def to_local(q, v):
    qx, qy, qw = q
    temp = 2.0 * (-qx * v[:, 1] + (v[:, 2] * qw + v[:, 0] * qy))
    return torch.stack([-qy * temp + v[:, 0], qx * temp + v[:, 1],
                        temp * qw - v[:, 2]], -1)


def to_world(q, v):
    qx, qy, qw = q
    temp = 2.0 * (qx * v[:, 1] + (v[:, 2] * qw - v[:, 0] * qy))
    return torch.stack([qy * temp + v[:, 0], -qx * temp + v[:, 1],
                        temp * qw - v[:, 2]], -1)


def orthonormal_basis(n):
    sign = torch.where(torch.signbit(n[:, 2]), -1.0, 1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    v2 = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                      -sign * n[:, 0]], -1)
    v3 = torch.stack([b, sign + a * n[:, 1] * n[:, 1], -n[:, 1]], -1)
    return v2, v3


def cone_pdf(cos_max):
    return (0.5 * INV_PI) / torch.clamp_min(1.0 - cos_max, 1e-6)


def sphere_pdf(r2, d2):
    return cone_pdf(sqrt(torch.clamp_min(1.0 - r2 / d2, 0.0)))


def sample_sphere(wc, sin2max, cd, r2, t, s):
    """Cone sample toward a sphere light (Sampling.hpp:220-239)."""
    cos_max = sqrt(torch.clamp_min(1.0 - sin2max, 0.0))
    pdf = cone_pdf(cos_max)
    small = sin2max < 0.00068523
    cos_t = fma(-t, 1.0 - cos_max, 1.0)
    sin_t = sqrt(sin2max * t)
    blend = torch.where(small, sin_t, cos_t)
    invert = sqrt(torch.clamp_min(fma(-blend, blend, 1.0), 0.0))
    cos_t = torch.where(small, invert, cos_t)
    sin_t = torch.where(small, sin_t, invert)
    temp = cd * sin_t
    raw = fma(cd, cos_t, -sqrt(torch.clamp_min(fma(-temp, temp, r2),
                                                     0.0)))
    dist = raw - torch.clamp_min(raw * 1e-5, 1e-5)
    phi = s * TWO_PI
    lx, ly, lz = sin_t * cos(phi), sin_t * sin(phi), cos_t
    bx, by = orthonormal_basis(wc)
    l_dir = bx * lx[:, None] + by * ly[:, None] + wc * lz[:, None]
    return l_dir, dist, pdf


# --------------------------------------------------------------------------
# Scene
# --------------------------------------------------------------------------
@dataclass
class Scene:
    """The scene on the device in `dtype`: spheres, triangles with their
    planes and culling groups, materials, lights, camera and sky."""

    sph_c: torch.Tensor
    sph_r2: torch.Tensor
    sph_mat: torch.Tensor
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor
    tri_area: torch.Tensor
    tri_mat: torch.Tensor
    planes: torch.Tensor  # [T, 12]: n, d0, f1, g1, f2, g2
    group_lo: torch.Tensor  # [G, 3]
    group_hi: torch.Tensor
    group_members: torch.Tensor  # [G, GROUP] int64, -1 = empty
    albedo: torch.Tensor
    emission: torch.Tensor
    lights: torch.Tensor  # sphere lights
    tri_lights: torch.Tensor
    cam_pos: torch.Tensor
    cam_q: torch.Tensor  # (x, y, z, w)
    half_w: float
    half_h: float
    cam_z: float
    sky: torch.Tensor  # [3]
    dtype: torch.dtype

    @property
    def n_tri(self) -> int:
        return self.tri_mat.shape[0]


def _groups(v0, v1, v2, device):
    """Culling groups of GROUP triangles in Morton order of their
    centroids, with their boxes, widened so that rounding in the slab test
    never drops a triangle's hit."""
    n = v0.shape[0]
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)
    cen = (lo + hi) * 0.5
    smin, smax = cen.min(0), cen.max(0)
    q = ((cen - smin) / np.maximum(smax - smin, 1e-30) * 1023).astype(np.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    order = np.argsort(code, kind="stable")
    g = -(-n // GROUP)
    members = np.full(g * GROUP, -1, np.int64)
    members[:n] = order
    members = members.reshape(g, GROUP)
    safe = np.maximum(members, 0)
    glo = np.where(members[..., None] >= 0, lo[safe], np.inf).min(1)
    ghi = np.where(members[..., None] >= 0, hi[safe], -np.inf).max(1)
    pad = (ghi - glo) * 1e-3 + 1e-4 * np.maximum(np.abs(glo), np.abs(ghi)) \
        + 1e-5
    return (torch.tensor(glo - pad, dtype=torch.float32, device=device),
            torch.tensor(ghi + pad, dtype=torch.float32, device=device),
            torch.tensor(members, device=device))


def _planes(v0, e1, e2):
    """Baldwin-Weber plane rows of the triangles."""
    n = cross(e1, e2)
    nn = dot(n, n)
    inv = torch.where(nn > 0.0, 1.0 / torch.clamp_min(nn, 1e-38), 0.0)
    f1 = cross(e2, n) * inv[:, None]
    f2 = -cross(e1, n) * inv[:, None]
    return torch.cat([n, dot(n, v0)[:, None], f1, -dot(f1, v0)[:, None], f2,
                      -dot(f2, v0)[:, None]], 1)


def make_scene(inputs: dict, device, dtype=torch.float32) -> Scene:
    """The reference's scene from the benchmark's scene inputs
    (``portbench.scenes.build``)."""
    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    emission = np.asarray(inputs["material_emission"], np.float32)
    sph_mat = np.asarray(inputs["sphere_material_id"], np.int64)
    tri_mat = np.asarray(inputs["tri_material_id"], np.int64)

    def light_list(mids):
        em = emission[mids]
        return np.nonzero((em * em).sum(-1) > 0.0)[0].astype(np.int64)

    v0 = np.asarray(inputs["tri_v0"], np.float32)
    e1 = np.asarray(inputs["tri_e1"], np.float32)
    e2 = np.asarray(inputs["tri_e2"], np.float32)
    tv0, te1, te2 = t(v0), t(e1), t(e2)
    if v0.shape[0]:
        glo, ghi, members = _groups(v0, v0 + e1, v0 + e2, device)
    else:
        glo = ghi = torch.zeros((0, 3), device=device)
        members = torch.zeros((0, GROUP), dtype=torch.int64, device=device)
    cam = inputs["camera"]
    return Scene(
        sph_c=t(inputs["sphere_center"]), sph_r2=t(inputs["sphere_radius_sq"]),
        sph_mat=t(sph_mat, torch.int64), tri_v0=tv0, tri_e1=te1, tri_e2=te2,
        tri_n=t(inputs["tri_normal"]), tri_area=t(inputs["tri_area"]),
        tri_mat=t(tri_mat, torch.int64), planes=_planes(tv0, te1, te2),
        group_lo=glo, group_hi=ghi, group_members=members,
        albedo=t(inputs["material_albedo"]), emission=t(emission),
        lights=t(light_list(sph_mat), torch.int64),
        tri_lights=t(light_list(tri_mat), torch.int64),
        cam_pos=t(cam["pos"]), cam_q=t(cam["orient"]),
        half_w=float(cam["half_width"]), half_h=float(cam["half_height"]),
        cam_z=float(cam["z"]), sky=t(inputs["sky_ambient"]), dtype=dtype)


# --------------------------------------------------------------------------
# Intersection
# --------------------------------------------------------------------------
def _sphere_roots(sc: Scene, o, d):
    tc = sc.sph_c[None] - o[:, None]  # [N, S, 3]
    b = dot_fused(d[:, None].expand_as(tc), tc)
    disc = fma(b, b, sc.sph_r2[None] - dot_fused(tc, tc))
    sq = sqrt(torch.clamp_min(disc, 0.0))
    near = b - sq
    t = torch.where(near < 0.0, b + sq, near)
    return t, (disc >= 0.0) & (t >= 0.0)


def closest_spheres(sc: Scene, o, d):
    t, ok = _sphere_roots(sc, o, d)
    t = torch.where(ok, t, torch.inf)
    best, idx = t.min(dim=1)
    return best, torch.where(torch.isfinite(best), idx, -1)


def occluded_spheres(sc: Scene, o, d, tmax):
    """Whether a sphere's selected root (the near one where it is >= 0,
    else the far one) lies in [0, tmax), decided without a square root:
    by the signs of b and b - tmax and by comparing their squares with
    disc, as the reference's any-hit test does."""
    tc = sc.sph_c[None] - o[:, None]
    b = dot_fused(d[:, None].expand_as(tc), tc)
    bb = b * b
    disc = sc.sph_r2[None] - dot_fused(tc, tc) + bb
    e = b - tmax[:, None]
    q = e * e
    near = torch.where((b >= 0.0) & (bb >= disc), (e < 0.0) | (q < disc),
                       ((b >= 0.0) | (bb <= disc)) & (e < 0.0) & (disc < q))
    return ((disc >= 0.0) & near).any(dim=1)


RAY_BLOCK = 8192  # rays a slab test against every group
PAIR_BLOCK = 1 << 16  # (ray, group) pairs a triangle test


def _candidate_pairs(sc: Scene, o, d, tmax):
    """(ray, group) pairs whose widened box the ray enters before tmax."""
    d32 = d.float()
    safe = torch.where(d32.abs() < 1e-30, torch.full_like(d32, 1e-30), d32)
    inv = 1.0 / safe
    o32 = o.float()
    a = (sc.group_lo[None] - o32[:, None]) * inv[:, None]
    b = (sc.group_hi[None] - o32[:, None]) * inv[:, None]
    tmin = torch.minimum(a, b).amax(-1)
    tmax_box = torch.maximum(a, b).amin(-1)
    enter = (tmax_box >= torch.clamp_min(tmin, 0.0)) \
        & (tmin < tmax.float()[:, None])
    return enter.nonzero(as_tuple=True)


def _triangle_t(sc: Scene, o, d, tri):
    """Distances of rays o, d [M, 3] against triangles tri [M, K] (-1 =
    none): +inf where the ray misses (the Baldwin-Weber test)."""
    rows = sc.planes[torch.clamp_min(tri, 0)]  # [M, K, 12]
    n, d0 = rows[..., 0:3], rows[..., 3]
    f1, g1 = rows[..., 4:7], rows[..., 7]
    f2, g2 = rows[..., 8:11], rows[..., 11]
    den = dot(n, d[:, None])
    t = (d0 - dot(n, o[:, None])) / den
    q = o[:, None] + t[..., None] * d[:, None]
    u = dot(f1, q) + g1
    v = dot(f2, q) + g2
    ok = ((den.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > 1e-6) & (tri >= 0))
    return torch.where(ok, t, torch.inf).float()


def _pair_blocks(sc: Scene, o, d, tmax):
    """Yields (ray index [M], triangle ids [M, GROUP], t [M, GROUP]) over
    the candidate pairs of the rays, in blocks; t is +inf where the ray
    misses the triangle or meets it at or beyond its tmax."""
    for r0 in range(0, o.shape[0], RAY_BLOCK):
        rs = slice(r0, r0 + RAY_BLOCK)
        ri, gi = _candidate_pairs(sc, o[rs], d[rs], tmax[rs])
        for p0 in range(0, ri.numel(), PAIR_BLOCK):
            r = ri[p0:p0 + PAIR_BLOCK] + r0
            tri = sc.group_members[gi[p0:p0 + PAIR_BLOCK]]
            t = _triangle_t(sc, o[r], d[r], tri)
            yield r, tri, torch.where(t < tmax.float()[r, None], t,
                                      torch.inf)


def closest_triangles(sc: Scene, o, d, tmax):
    """Closest triangle strictly nearer than tmax: (t, id, -1 = none); of
    equally near ones the lowest id."""
    n = o.shape[0]
    best = torch.full((n,), torch.inf, device=o.device)
    big = torch.iinfo(torch.int64).max
    cand = torch.full((n,), big, dtype=torch.int64, device=o.device)
    if sc.n_tri == 0 or n == 0:
        return best, torch.full_like(cand, -1)
    blocks = []
    for r, tri, t in _pair_blocks(sc, o, d, tmax):
        best.scatter_reduce_(0, r, t.min(dim=1).values, "amin")
        blocks.append((r, tri, t))
    for r, tri, t in blocks:
        at_best = (t == best[r, None]) & torch.isfinite(t)
        ids = torch.where(at_best, tri, big).min(dim=1).values
        cand.scatter_reduce_(0, r, ids, "amin")
    return best, torch.where(torch.isfinite(best), cand, -1)


def occluded_triangles(sc: Scene, o, d, tmax):
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    if sc.n_tri == 0:
        return occ
    for r, _, t in _pair_blocks(sc, o, d, tmax):
        occ[r[torch.isfinite(t).any(dim=1)]] = True
    return occ


def closest(sc: Scene, o, d):
    """(t, prim, is_tri): spheres first, then triangles strictly nearer."""
    t, prim = closest_spheres(sc, o, d)
    t2, id2 = closest_triangles(sc, o, d, t)
    is_tri = id2 >= 0
    return (torch.where(is_tri, t2, t), torch.where(is_tri, id2, prim),
            is_tri)


def occluded(sc: Scene, o, d, tmax):
    return occluded_spheres(sc, o, d, tmax) | occluded_triangles(sc, o, d,
                                                                 tmax)


# --------------------------------------------------------------------------
# Paths
# --------------------------------------------------------------------------
@dataclass
class Policy:
    max_bounces: int
    spp: int
    stratify: bool
    tile_root: int = 16


def policy(port_policy) -> Policy:
    """The reference's policy for the port's, refusing knobs it does not
    render."""
    plain = {"brdf": "lambertian", "light_sampling": "uniform", "mis": True,
             "russian_roulette": True, "median": True,
             "accumulation_buckets": 5, "clamp_radiance": False,
             "sky_bug_compat": False, "enable_dof": False,
             "rng_scramble": False, "log_tile": 4}
    off = {k: getattr(port_policy, k) for k, v in plain.items()
           if getattr(port_policy, k) != v}
    if off:
        raise ValueError(f"the reference does not render {off}")
    return Policy(port_policy.max_bounces, port_policy.samples_per_pixel,
                  port_policy.stratify_camera)


def lane_seeds(pixel, sample, width: int, pol: Policy):
    """Per-path base seed (Renderer.hpp:85-107): the tile-ordered path
    index, times spp plus the sample, times 2 * max_bounces + 1."""
    tr = pol.tile_root
    x, y = pixel % width, pixel // width
    launch = (y // tr) * (-(-width // tr)) + (x // tr)
    path = (mul32(launch, tr * tr) + (y % tr) * tr + (x % tr)) & MASK
    if pol.spp > 1:
        path = (mul32(path, pol.spp) + sample) & MASK
    return mul32(path, 2 * pol.max_bounces + 1)


def camera_rays(sc: Scene, pixel, acc, seeds, width: int, pol: Policy):
    dt = sc.dtype
    j0, j1 = draws(hash_2d(acc, seeds), 2, dt)
    if pol.stratify:
        vdc = unit(bitreverse32(acc), dt)
        gr = torch.remainder(acc.to(dt) * GOLDEN, 1.0)
        ox = unit(hash_u32(seeds), dt)
        oy = unit(hash_u32(seeds ^ 0x9E3779B9), dt)
        j0 = torch.remainder(vdc + ox, 1.0)
        j1 = torch.remainder(gr + oy, 1.0)
    vx = (pixel % width).to(dt) + j0 - sc.half_w
    vy = (pixel // width).to(dt) + j1 - sc.half_h
    z2 = float(np.float32(sc.cam_z) * np.float32(sc.cam_z))
    inv = rsqrt(torch.clamp_min(vx * vx + vy * vy + z2, 1e-30))
    view = torch.stack([vx * inv, vy * inv, torch.full_like(vx, sc.cam_z)
                        * inv], -1)
    qv = sc.cam_q[:3].expand_as(view)
    tt = 2.0 * cross(qv, view)
    d = view + tt * sc.cam_q[3] + cross(qv, tt)
    return sc.cam_pos.expand_as(d).clone(), d


def _bounce(sc: Scene, pol: Policy, bounce: int, acc, seeds, o, d, thr,
            prev_pdf):
    """One bounce of live paths: (radiance added, alive next, o, d, thr,
    pdf)."""
    dt = sc.dtype
    n_s, n_t = sc.lights.shape[0], sc.tri_lights.shape[0]
    n_l = n_s + n_t
    t, prim, is_tri = closest(sc, o, d)
    hit = prim >= 0
    t = torch.where(hit, t, 0.0).to(dt)
    hit_pt = fma(d, t[:, None], o)
    sph = torch.clamp_min(torch.where(is_tri, 0, prim), 0)
    tri = torch.clamp_min(torch.where(is_tri, prim, 0), 0)
    n = torch.where(is_tri[:, None], sc.tri_n[tri] if sc.n_tri else hit_pt,
                    normalize(hit_pt - sc.sph_c[sph]))
    mat = torch.where(is_tri, sc.tri_mat[tri] if sc.n_tri else sph,
                      sc.sph_mat[sph])
    n = torch.where((dot(n, d) >= 0.0)[:, None], -n, n)
    q = tangent_space(n)
    v_local = to_local(q, -d)
    eps = torch.clamp_min(3e-5 * hit_pt.abs().amax(-1), 1e-4)
    p_off = fma(n, eps[:, None], hit_pt)
    albedo, em = sc.albedo[mat], sc.emission[mat]
    zero3 = torch.zeros_like(o)
    rad = zero3

    # next-event estimation (Renderer.hpp:247-314)
    if n_l > 0:
        t_draw, s_draw, f = draws(hash_2d(acc, (seeds + 2 * bounce) & MASK),
                                  3, dt)
        sel = torch.clamp_max((f * float(n_l)).to(torch.int64), n_l - 1)
        l_dir, l_dist, l_pdf, l_em = zero3, torch.zeros_like(t), \
            torch.zeros_like(t), zero3
        ok_any = torch.zeros_like(hit)
        if n_s > 0:
            lp = sc.lights[torch.clamp(sel, 0, n_s - 1)]
            lc, lr2 = sc.sph_c[lp], sc.sph_r2[lp]
            wc = lc - p_off
            cd2 = dot_fused(wc, wc)
            ok = hit & (sel < n_s) & ~(~is_tri & (lp == prim)) & (cd2 > lr2)
            cd = sqrt(cd2)
            wc = wc * (1.0 / torch.clamp_min(cd, 1e-20))[:, None]
            sin2max = lr2 / torch.clamp_min(cd2, 1e-20)
            ndw = to_local(q, wc)[:, 2]
            ok = ok & ~((ndw < 0.0) & (sin2max < ndw * ndw))
            sd, sdist, spdf = sample_sphere(wc, sin2max, cd, lr2, t_draw,
                                            s_draw)
            l_dir = torch.where(ok[:, None], sd, l_dir)
            l_dist = torch.where(ok, sdist, l_dist)
            l_pdf = torch.where(ok, spdf, l_pdf)
            l_em = torch.where(ok[:, None], sc.emission[sc.sph_mat[lp]], l_em)
            ok_any = ok_any | ok
        if n_t > 0:
            lt = sc.tri_lights[torch.clamp(sel - n_s, 0, n_t - 1)]
            su = sqrt(torch.clamp_min(t_draw, 0.0))
            a, b = su * (1.0 - s_draw), su * s_draw
            pt = sc.tri_v0[lt] + sc.tri_e1[lt] * a[:, None] \
                + sc.tri_e2[lt] * b[:, None]
            to_l = pt - p_off
            dist2 = dot(to_l, to_l)
            dist = sqrt(torch.clamp_min(dist2, 1e-20))
            tdir = to_l * (1.0 / dist)[:, None]
            cos_l = dot(tdir, sc.tri_n[lt]).abs()
            tpdf = dist2 / torch.clamp_min(sc.tri_area[lt] * cos_l, 1e-9)
            ok = hit & (sel >= n_s) & ~(is_tri & (lt == prim)) \
                & (cos_l > 1e-6)
            l_dir = torch.where(ok[:, None], tdir, l_dir)
            l_dist = torch.where(
                ok, dist - torch.clamp_min(dist * 3e-5, 1e-4), l_dist)
            l_pdf = torch.where(ok, tpdf, l_pdf)
            l_em = torch.where(ok[:, None], sc.emission[sc.tri_mat[lt]], l_em)
            ok_any = ok_any | ok
        l_local = to_local(q, l_dir)
        valid = ok_any & (l_local[:, 2] >= 0.0)
        cos_l = torch.clamp_min(l_local[:, 2], 0.0)
        shade = l_em * thr * (albedo * (INV_PI * cos_l)[:, None])
        l_pdf = l_pdf * (1.0 / n_l)
        brdf_pdf = INV_PI * cos_l
        shade = shade * (l_pdf / torch.clamp_min(
            l_pdf * l_pdf + brdf_pdf * brdf_pdf, 1e-6))[:, None]
        valid = valid & (shade.amax(-1) > 0.0)
        occ = occluded(sc, p_off, l_dir, torch.where(valid, l_dist, 0.0))
        rad = rad + torch.where((valid & ~occ)[:, None], shade, zero3)

    # emissive hit with MIS (Renderer.hpp:319-353)
    emissive = hit & (em.amax(-1) > FLT_EPSILON)
    if bounce == 0 or n_l == 0:
        weight = torch.ones_like(t)
    else:
        r2 = sc.sph_r2[sph]
        ndv = v_local[:, 2]
        cd2 = t * (ndv * (2.0 * sqrt(r2)) + t) + r2
        light_pdf = sphere_pdf(r2, torch.clamp_min(cd2, 1e-20)) / n_l
        if n_t > 0:
            tri_pdf = (t * t) / torch.clamp_min(
                sc.tri_area[tri] * ndv.abs(), 1e-9) / n_l
            light_pdf = torch.where(is_tri, tri_pdf, light_pdf)
        f2 = prev_pdf * prev_pdf
        weight = f2 / torch.clamp_min(light_pdf * light_pdf + f2, 1e-6)
    rad = rad + torch.where(emissive[:, None], thr * em * weight[:, None],
                            zero3)

    # lambertian sample and Russian roulette (Renderer.hpp:357-404)
    u, v, rr = draws(hash_2d(acc, (seeds + 2 * bounce + 1) & MASK), 3, dt)
    sin_t, cos_t, phi = sqrt(u), sqrt(torch.clamp_min(1.0 - u,
                                                                   0.0)), \
        v * TWO_PI
    local = torch.stack([sin_t * cos(phi), sin_t * sin(phi),
                         cos_t], -1)
    new_thr = thr * albedo
    qq = 1.0 - new_thr.amax(-1)
    kill = rr < qq
    new_thr = new_thr * (1.0 / torch.clamp_min(1.0 - qq, FLT_EPSILON))[:, None]
    world = to_world(q, local)
    pdf = INV_PI * torch.clamp_min(local[:, 2], 0.0)

    # miss: the constant sky (Renderer.hpp:408-420)
    if float(sc.sky.float().max()) > 0.0:
        rad = rad + torch.where((~hit)[:, None], thr * sc.sky, zero3)
    alive = hit & ~kill & (bounce + 1 < pol.max_bounces)
    return rad, alive, p_off, world, new_thr, pdf


def trace(sc: Scene, pol: Policy, pixel, sample, acc, width: int):
    """Radiance [N, 3] of the lanes (pixel, sample, pass `acc`)."""
    seeds = lane_seeds(pixel, sample, width, pol)
    o, d = camera_rays(sc, pixel, acc, seeds, width, pol)
    n = o.shape[0]
    rad = torch.zeros((n, 3), dtype=sc.dtype, device=o.device)
    thr = torch.ones_like(rad)
    pdf = torch.zeros((n,), dtype=sc.dtype, device=o.device)
    live = torch.arange(n, device=o.device)
    for bounce in range(pol.max_bounces):
        if live.numel() == 0:
            break
        add, alive, o, d, thr, pdf = _bounce(
            sc, pol, bounce, acc[live], seeds[live], o, d, thr, pdf)
        rad.index_add_(0, live, add)
        keep = alive.nonzero(as_tuple=True)[0]
        live, o, d, thr, pdf = live[keep], o[keep], d[keep], thr[keep], \
            pdf[keep]
    return rad


def buckets(sc: Scene, pol: Policy, pixels: torch.Tensor, first_pass: int,
            n_passes: int, width: int, n_buckets: int = 5,
            lanes_per_block: int = 1 << 18):
    """[n_buckets, 3, P] sums of the passes first_pass .. + n_passes - 1
    (u32 indices; pass a goes to bucket a % n_buckets) at `pixels`, each
    pass's samples summed in sample order, the passes added in order."""
    dev = pixels.device
    p = pixels.shape[0]
    spp = pol.spp
    out = torch.zeros((n_buckets, 3, p), dtype=sc.dtype, device=dev)
    per_pass = p * spp
    step = max(1, lanes_per_block // per_pass)
    pix = pixels.to(torch.int64).repeat_interleave(spp)
    smp = torch.arange(spp, device=dev).repeat(p)
    for k0 in range(0, n_passes, step):
        k1 = min(n_passes, k0 + step)
        ks = torch.arange(k0, k1, device=dev)
        acc = ((first_pass + ks) & MASK).repeat_interleave(per_pass)
        rad = trace(sc, pol, pix.repeat(k1 - k0), smp.repeat(k1 - k0), acc,
                    width)
        rad = rad.reshape(k1 - k0, p, spp, 3)
        per_pixel = rad[:, :, 0]
        for s in range(1, spp):
            per_pixel = per_pixel + rad[:, :, s]
        for i, k in enumerate(range(k0, k1)):
            out[((first_pass + k) & MASK) % n_buckets] += per_pixel[i].T
    return out


# --------------------------------------------------------------------------
# Resolve (Renderer.hpp:436-478, Color.hpp:39-73)
# --------------------------------------------------------------------------
_ACES_IN = ((0.59719, 0.35458, 0.04823), (0.07600, 0.90834, 0.01566),
            (0.02840, 0.13383, 0.83777))
_ACES_OUT = ((1.604750, -0.53108, -0.07367), (-0.10208, 1.10813, -0.00605),
             (-0.00327, -0.07276, 1.07602))


def _median5(v):
    return v.sort(dim=0).values[2]


def resolve(bk: torch.Tensor, accumulations: int, spp: int,
            exposure: float = 1.0):
    """Median of the 5 bucket means, scaled by exposure / (accumulations //
    5 * spp), then ACES: [P, 3] in [0, 1]."""
    n_b = bk.shape[0]
    scale = exposure / (max(accumulations // n_b, 1) * spp)
    lin = _median5(bk) * scale  # [3, P]

    def fit(x):
        return (x * (x + 0.0245786) - 0.000090537) / (
            x * (0.983729 * x + 0.4329510) + 0.238081)

    mid = [fit(w[0] * lin[0] + w[1] * lin[1] + w[2] * lin[2])
           for w in _ACES_IN]
    return torch.stack([torch.clamp(w[0] * mid[0] + w[1] * mid[1]
                                    + w[2] * mid[2], 0.0, 1.0)
                        for w in _ACES_OUT], -1)
