"""The wavefront path tracer, ported from the JAX package's
``render/renderer.py`` for scenes of spheres and triangles under every
``accel`` ('brute', 'pallas', 'clustered', 'grid', 'bvh').

Structure of one bounce (``bounce_step``, Renderer.hpp:131-432): intersect
(the closest-hit battery, the clustered traversal, the BVH or the grid
walk) -> closest-hit frame
-> NEE with MIS and a shadow any-hit (the light picked uniformly, by
power, from an alias table, by RIS or by ReSTIR with per-pixel reservoirs)
-> emissive hit with MIS -> BSDF sample (lambertian, GGX or principled) +
Russian roulette -> miss/sky.
``trace_rays`` runs bounces over one chunk of rays as a Python loop with
mask-based termination: it stops at
``max_bounces`` or when no lane is alive, and with narrowing on it compacts
the live lanes to the front of a narrower wavefront once they fit.
``render_pass`` generates camera rays (pinhole or thin lens, jittered or
stratified) in raster or screen-tile order, samples_per_pixel of them a
pixel, and walks ``rays_per_chunk`` chunks; the padding lanes of the last
chunk are dead from bounce 0.

RNG is the counter scheme of ``core/rng.py``, bit for bit the JAX package's,
so both packages draw the same numbers at every decision point. A knob
the port does not render would raise ``NotImplementedError``
(``check_policy``); of the policy's knobs only an unknown ``pallas_plan``
does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import fp, rng, sampling
from ..core.fp import fma
from ..core.rng import MASK, add32, mul32
from ..core.vec import Quat, Vec3
from ..ops import closures, intersect
from ..ops import gather as fast_gather
from ..ops.kernels import light_rows
from ..ops.kernels.cluster_traverse import PLANS, compact_order
from ..scene.scene import Scene
from ..utils.config import RendererPolicy

FLT_EPSILON = 1.1920928955078125e-07  # float32(1.1920929e-7)
THIRD = float(np.float32(1.0 / 3.0))


class PathState(NamedTuple):
    """Per-ray SoA wavefront state (DataStreams.hpp:74-105)."""

    bounce: int
    p: Vec3  # [R] ray origin
    d: Vec3  # [R] ray direction
    throughput: Vec3
    radiance: Vec3
    prev_pdf: torch.Tensor  # [R] BRDF pdf of the previous bounce (MIS)
    prev_delta: torch.Tensor  # [R] bool: previous bounce sampled a delta lobe
    alive: torch.Tensor  # [R] bool
    ray_count: torch.Tensor  # 0-d int64 holding a u32: useful rays traced
    # (closest-hit + valid shadow rays), the Mrays/s numerator


def narrowing_on(policy: RendererPolicy, scene: Scene) -> bool:
    """Whether ``narrow_wavefront`` resolves to on (renderer.py:931-954 of
    the JAX package): 'auto' engages at >= 64 prims, spheres and triangles
    together, or under accel='pallas'."""
    nw = policy.narrow_wavefront
    if nw == "auto":
        nw = scene.num_prims >= 64 or policy.effective_accel == "pallas"
    return bool(nw)


def check_policy(policy: RendererPolicy):
    """Refuse every knob this port does not render, by name and before any
    work, so that no knob silently changes the result.

    Every ``brdf`` renders ('lambertian', 'ggx', 'principled', with
    ``shade_f80``), as do ``enable_dof``, ``stratify_camera``,
    ``rng_scramble``, any ``samples_per_pixel`` and every
    ``light_sampling`` ('uniform', 'power', 'alias', 'ris' and 'restir'
    with its ``restir_*`` knobs).

    ``accel`` / ``primary_accel`` take every value the JAX package's
    ``RendererPolicy`` takes ('brute', 'bvh', 'grid', 'clustered',
    'pallas'; ``use_bvh=True`` means 'bvh'); a backend whose table the
    scene lacks renders with the dense batteries, as in the JAX package
    (``ops/intersect.py::_accel_passes``). Of the pallas_*
    knobs, ``pallas_tile_rays``, ``pallas_compact``, ``pallas_stream`` and
    ``pallas_mxu`` act as in the JAX package (``RendererPolicy`` itself
    refuses ``pallas_stream=True`` together with ``pallas_mxu``; a pack of
    fewer than 128 prims a cluster switches both off for itself).
    ``pallas_unroll``, ``pallas_fuse``, ``pallas_trav_block``,
    ``pallas_exit_refresh``, ``pallas_prefetch`` and ``pallas_plan_block``
    are accepted and change nothing: they choose among TPU schedules that
    the JAX package's tests hold bit-identical, and the CUDA kernels have one
    schedule. ``pallas_interpret`` is accepted and ignored likewise. The
    planners render: ``pallas_plan`` 'ray', 'auto', 'super', 'group',
    'tilebox' and 'hybrid', ``pallas_sort_impl`` 'kernel' and 'xla' and
    ``pallas_sort_visits`` either way; another ``pallas_plan`` is refused.
    A pack of any cluster count plans: above what the sorting planner
    kernel holds in one block (``cluster_traverse.max_plan_clusters``) the
    planner writes the entry matrix and sorts it in PyTorch, with the same
    lists."""
    if ("pallas" in (policy.effective_accel, policy.primary_accel)
            and policy.pallas_plan not in ("auto",) + PLANS):
        raise NotImplementedError("not ported to PyTorch yet: "
                                  f"pallas_plan={policy.pallas_plan!r}")


def path_index_from_pixel(i, width: int, policy: RendererPolicy):
    """Tile-ordered path index (tile_index * TileSize + intra_tile_id) under
    the reference's 16x16 tile decomposition (Renderer.hpp:85-88, 107)."""
    tr = policy.tile_root
    h_tiles = -(-width // tr)
    x = i % width
    y = i // width
    launch = (y // tr) * h_tiles + (x // tr)
    tid = (y % tr) * tr + (x % tr)
    return add32(mul32(launch, policy.tile_size), tid)


def pixel_seeds_from_index(i, width: int, policy: RendererPolicy, sample=None):
    """Per-path base seed (Renderer.hpp:107): path * (2*max_bounces + 1); with
    samples_per_pixel > 1 the stream index is path * spp + sample."""
    path = path_index_from_pixel(i, width, policy)
    spp = policy.samples_per_pixel
    if spp > 1:
        path = add32(mul32(path, spp), 0 if sample is None else sample)
    return mul32(path, 2 * policy.max_bounces + 1)


def pixel_seeds(width: int, height: int, policy: RendererPolicy, device=None):
    i = torch.arange(width * height, dtype=torch.int64, device=device)
    return pixel_seeds_from_index(i, width, policy)


def _site_state(accumulation, counter, policy: RendererPolicy):
    """RNG site state (Renderer.hpp:117/255/362), avalanche-scrambled under
    ``policy.rng_scramble`` to break hash_2d's lattice structure."""
    state = rng.hash_2d(accumulation, counter)
    if policy.rng_scramble:
        state = rng.hash_u32(state)
    return state


GOLDEN_RATIO_CONJUGATE = 0.6180339887498949


def _stratified_jitter(accumulation, seeds, device):
    """The pixel jitter of ``stratify_camera``: van der Corput in base 2 over
    the accumulation index (the bitreverse the reference computes but never
    uses, Renderer.hpp:80) and a golden-ratio second dimension, rotated per
    pixel (Cranley-Patterson) by hashed-pixel offsets. All sums are >= 0,
    where ``torch.remainder`` and the JAX package's ``jnp.mod`` are exact."""
    acc = rng.u32(accumulation, device)
    vdc = rng.make_unit_float(rng.bitreverse32(acc))
    gr = torch.remainder(acc.to(torch.float32) * GOLDEN_RATIO_CONJUGATE, 1.0)
    ox = rng.make_unit_float(rng.hash_u32(seeds))
    oy = rng.make_unit_float(rng.hash_u32(seeds ^ 0x9E3779B9))
    return torch.remainder(vdc + ox, 1.0), torch.remainder(gr + oy, 1.0)


def generate_camera_rays(camera, x, y, accumulation, seeds, enable_dof: bool,
                         policy: RendererPolicy = None) -> Tuple[Vec3, Vec3]:
    """Primary rays (Camera.hpp:80-88 + Renderer.hpp:113-127): pinhole, or
    with `enable_dof` the thin lens the reference declares but never wires
    (Camera.hpp:17-26): a point of the aperture disk, retargeted through the
    focus plane. ``policy.stratify_camera`` replaces the pixel jitter by
    ``_stratified_jitter``; ``policy.rng_scramble`` scrambles the site
    state. Returns contiguous [R] components, the layout the batteries
    take."""
    policy = policy or RendererPolicy()
    state = _site_state(accumulation, seeds, policy)
    state, ds = rng.draws(state, 4 if enable_dof else 2)
    if policy.stratify_camera:
        ds[:2] = _stratified_jitter(accumulation, seeds, ds[0].device)
    vx = x.to(torch.float32) + ds[0] - camera.half_width
    vy = y.to(torch.float32) + ds[1] - camera.half_height
    origin = Vec3(*(c.expand(vx.shape).contiguous() for c in camera.pos))
    if enable_dof:
        return _thin_lens(camera, vx, vy, origin, ds[2], ds[3])
    # view_dir.z is one scalar for the whole batch: XLA squares it once,
    # outside the elementwise loop, so only x*x + y*y of |v|^2 contracts
    len_sq = fma(vx, vx, vy * vy) + camera.z * camera.z
    inv = fp.rsqrt(torch.clamp_min(len_sq, 1e-30))
    view_dir = Vec3(vx * inv, vy * inv, camera.z * inv)
    return origin, camera.orient.rotate(view_dir)


def _thin_lens(camera, vx, vy, origin: Vec3, u2, u3):
    """The thin-lens ray of ``generate_camera_rays`` from the camera's third
    and fourth draws: the focus plane lies at view-space depth
    focus_distance along -Z; the view direction is not normalized before it
    is scaled onto that plane."""
    scale = camera.focus_distance / torch.clamp_min(-camera.z, 1e-6)
    lx, ly = sampling.disk(u3, u2)
    lens_x = lx * camera.aperture_radius
    lens_y = ly * camera.aperture_radius
    zero = torch.zeros_like(lens_x)
    # focal_pt - lens: the focal product fuses; z is one scalar
    dx = fma(vx, scale, -lens_x)
    dy = fma(vy, scale, -lens_y)
    dz = camera.z * scale
    inv = fp.rsqrt(torch.clamp_min(fma(dx, dx, dy * dy) + dz * dz, 1e-30))
    local_dir = Vec3(dx * inv, dy * inv, dz * inv)
    # orient.rotate(lens) with lens.z = 0: XLA drops v.z + t.z*w's zero
    # addend, and the product t.z*w then fuses with the cross term
    q = camera.orient
    qv = Vec3(q.x, q.y, q.z)
    t = qv.cross(Vec3(lens_x, lens_y, zero)) * 2.0
    turn = qv.cross(t)
    world_lens = Vec3(fma(t.x, q.w, lens_x) + turn.x,
                      fma(t.y, q.w, lens_y) + turn.y, fma(t.z, q.w, turn.z))
    return origin + world_lens, camera.orient.rotate(local_dir)


def _closest_hit_frame(scene: Scene, state: PathState, tfar, prim_id, is_tri):
    """Closest-hit shading inputs (Renderer.hpp:169-214): offset hit point,
    backface-flipped normal, tangent quat, local view vector, material id.
    Ids are clamped before the gather: a miss (-1) must not index."""
    safe_sphere = torch.clamp_min(torch.where(is_tri, 0, prim_id), 0)
    hit_pt = fp.fma3(state.d, tfar, state.p)
    sp = scene.spheres
    scx, scy, scz, s_rsq, mat_id = fast_gather.gather_cols(
        safe_sphere, sp.center.x, sp.center.y, sp.center.z, sp.radius_sq,
        sp.material_id)
    n = (hit_pt - Vec3(scx, scy, scz)).normalize()
    prim_extra = {"radius_sq": s_rsq}
    tg = scene.triangles
    if tg is not None:
        # the geometric normal and the material of the hit triangle
        safe_tri = torch.clamp_min(torch.where(is_tri, prim_id, 0), 0)
        tnx, tny, tnz, t_mid, t_area = fast_gather.gather_cols(
            safe_tri, tg.normal.x, tg.normal.y, tg.normal.z, tg.material_id,
            tg.area)
        n = Vec3(tnx, tny, tnz).where(is_tri, n)
        mat_id = torch.where(is_tri, t_mid, mat_id)
        prim_extra["area"] = t_area
    backface = n.dot(state.d) >= 0.0
    n = (-n).where(backface, n)
    t = sampling.tangent_space(n)
    # rounded as the JAX renderer's jitted _closest_hit_frame contracts it
    v_local = sampling.to_local(t, -state.d, fuse_xy=True)
    # scale-aware normal offset against self-intersection
    eps = torch.clamp_min(3e-5 * torch.maximum(
        torch.abs(hit_pt.x),
        torch.maximum(torch.abs(hit_pt.y), torch.abs(hit_pt.z))), 1e-4)
    p_offset = fp.fma3(n, eps, hit_pt)
    return p_offset, n, t, v_local, mat_id, backface, hit_pt, prim_extra


def _closure_eval(policy: RendererPolicy, mat: dict, l_local: Vec3,
                  v_local: Vec3) -> Vec3:
    """The policy's BSDF times NdotL for light direction `l_local`."""
    if policy.brdf == "lambertian":
        return closures.lambert_eval(mat["albedo"], l_local, v_local)
    if policy.brdf == "ggx":
        return closures.ggx_eval(mat["f0"], mat["alpha"], l_local, v_local,
                                 mat.get("f80"))
    return closures.principled_eval(
        mat["albedo"], mat["f0"], mat["transmission"], mat["alpha"],
        l_local, v_local, mat.get("f80"))


def _closure_pdf(policy: RendererPolicy, mat: dict, l_local: Vec3,
                 v_local: Vec3):
    """The solid-angle pdf with which the policy's BSDF samples `l_local`."""
    if policy.brdf == "lambertian":
        return closures.lambert_pdf(l_local)
    if policy.brdf == "ggx":
        return closures.ggx_pdf(mat["alpha"], l_local, v_local)
    return closures.principled_pdf(
        mat["albedo"], mat["f0"], mat["transmission"], mat["alpha"],
        l_local, v_local)


def _gather_material(scene: Scene, policy: RendererPolicy, mat_id) -> dict:
    """One packed gather of the material columns the bounce reads
    (renderer.py:1062-1100 of the JAX package): albedo and emission; f0 and
    alpha = roughness^2 under a specular closure; transmission and ior
    under 'principled'; f80 under ``shade_f80`` with a specular closure
    (the reference declares F80 but never shades it, Primitives.hpp:22).
    The JAX package gathers f0 and roughness for lambertian too; nothing
    reads them there."""
    mt = scene.materials
    cols = [*mt.albedo, *mt.emission]
    specular = policy.brdf in ("ggx", "principled")
    if specular:
        cols += [*mt.f0, mt.roughness]
    if policy.brdf == "principled":
        cols += [*mt.transmission, mt.ior_minus_one]
    if specular and policy.shade_f80:
        cols += list(mt.f80)
    mv = iter(fast_gather.gather_cols(mat_id, *cols))

    def take3():
        return Vec3(next(mv), next(mv), next(mv))

    mat = {"albedo": take3(), "emission": take3()}
    if specular:
        mat["f0"] = take3()
        rough = next(mv)
        mat["alpha"] = rough * rough
    if policy.brdf == "principled":
        mat["transmission"] = take3()
        mat["ior"] = next(mv) + 1.0
    if specular and policy.shade_f80:
        mat["f80"] = take3()
    return mat


def _light_selection_weights(scene: Scene, point: Vec3):
    """[R, L] unnormalized selection weights of power-proportional light
    selection (renderer.py:235-272 of the JAX package): max emission times
    the approximate solid angle the light subtends from `point`, sphere
    lights first, then triangle lights (from the centroid v0 + (e1 + e2) /
    3). |d|^2 and the centroid contract as XLA contracts them."""
    em_all = scene.materials.emission
    cols = []

    def weights(cx, cy, cz, em, size):
        dx = cx[None, :] - point.x[:, None]
        dy = cy[None, :] - point.y[:, None]
        dz = cz[None, :] - point.z[:, None]
        d2 = fp.dot3(dx, dy, dz, dx, dy, dz)
        return torch.div((em * size)[None, :],
                         torch.maximum(d2, size[None, :]))

    if scene.num_lights > 0:
        sl = scene.lights.to(torch.int64)
        sp = scene.spheres
        mid = sp.material_id[sl].to(torch.int64)
        em = Vec3(em_all.x[mid], em_all.y[mid], em_all.z[mid])
        cols.append(weights(sp.center.x[sl], sp.center.y[sl],
                            sp.center.z[sl], em.max_component(),
                            sp.radius_sq[sl]))
    if scene.num_tri_lights > 0:
        tl = scene.tri_lights.to(torch.int64)
        tri = scene.triangles
        # XLA divides by 3 as a product by float32(1/3), fused with + v0
        cx, cy, cz = (fma(e1[tl] + e2[tl], THIRD, v0[tl])
                      for v0, e1, e2 in zip(tri.v0, tri.e1, tri.e2))
        mid = tri.material_id[tl].to(torch.int64)
        em = Vec3(em_all.x[mid], em_all.y[mid], em_all.z[mid])
        cols.append(weights(cx, cy, cz, em.max_component(), tri.area[tl]))
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)


def _uniform_pick(f, light_count: int):
    """The light a unit draw picks uniformly, bit-identical to the
    reference's rand_bounded_int (Random.hpp:31-34): int64 [R]."""
    return torch.clamp_max((f * float(light_count)).to(torch.int64),
                           light_count - 1)


def _select_light(scene: Scene, policy: RendererPolicy, point: Vec3, f,
                  light_count: int):
    """Select a light from one unit draw `f`: (selected [R] int64, selection
    pdf), the pdf a Python float under uniform selection. 'power' takes
    the row total and the running sum of the weights in XLA's order
    (``ops/kernels/light_rows.py``), with the uniform pick where a row's
    weights are all zero; 'alias' one row of the scene's alias table."""
    if policy.light_sampling == "uniform" or light_count == 1:
        return _uniform_pick(f, light_count), 1.0 / light_count
    if policy.light_sampling == "alias" and scene.light_alias is not None:
        # O(1) in L: one alias-row gather picks the light and its pdf
        u = f * float(light_count)
        b = torch.clamp_max(u.to(torch.int32), light_count - 1)
        frac = u - b.to(torch.float32)
        row = fast_gather.gather_rows(scene.light_alias.table, b)
        take_bin = frac < row[:, 0]
        sel = torch.where(take_bin, b, row[:, 1].to(torch.int32))
        return sel.to(torch.int64), torch.where(take_bin, row[:, 2],
                                                row[:, 3])
    w = _light_selection_weights(scene, point)
    total, sel, p_sel = light_rows.light_rows(w, f)
    ok = total > 0.0  # all-zero weights: the uniform pick
    return (torch.where(ok, sel.to(torch.int64),
                        _uniform_pick(f, light_count)),
            torch.where(ok, p_sel, 1.0 / light_count))


def _hit_light_selection_pdf(scene, policy, state, prim_id, is_tri,
                             light_count):
    """The selection pdf with which the previous shading point (the ray
    origin, state.p) would have picked the light just hit: 1/L under
    uniform selection, the prim's entry of the alias table's pdfs under
    'alias', its weight over the row total at state.p under 'power'. A
    lane whose hit prim is no light gets 1/L (masked out downstream)."""
    if policy.light_sampling == "uniform" or light_count == 1:
        return 1.0 / light_count
    safe = torch.clamp_min(prim_id, 0).to(torch.int64)
    la = scene.light_alias
    if policy.light_sampling == "alias" and la is not None:
        p = la.sphere_pdf[torch.clamp_max(safe, la.sphere_pdf.shape[0] - 1)]
        if la.tri_pdf is not None:
            p = torch.where(is_tri, la.tri_pdf[torch.clamp_max(
                safe, la.tri_pdf.shape[0] - 1)], p)
        return torch.where(p > 0.0, p, 1.0 / light_count)
    w = _light_selection_weights(scene, state.p)
    # XLA fuses this sum with the weights (row_sum's `fused` order)
    total = torch.clamp_min(light_rows.light_rows(w, fused=True)[0], 1e-30)
    # the hit prim's column: its index in the light lists (each prim is
    # listed at most once, so this is the JAX package's first match)
    n_s = scene.num_lights
    idx = torch.full_like(safe, -1)
    if n_s > 0:
        col = torch.full((scene.spheres.count,), -1, dtype=torch.int64,
                         device=safe.device)
        col[scene.lights.to(torch.int64)] = torch.arange(
            n_s, device=safe.device)
        idx = torch.where(~is_tri & (prim_id >= 0),
                          col[torch.clamp_max(safe, col.shape[0] - 1)], idx)
    if scene.num_tri_lights > 0:
        col = torch.full((scene.triangles.count,), -1, dtype=torch.int64,
                         device=safe.device)
        col[scene.tri_lights.to(torch.int64)] = torch.arange(
            n_s, n_s + scene.num_tri_lights, device=safe.device)
        idx = torch.where(is_tri & (prim_id >= 0),
                          col[torch.clamp_max(safe, col.shape[0] - 1)], idx)
    found = idx >= 0
    p = torch.div(w.gather(1, torch.clamp_min(idx, 0)[:, None])[:, 0], total)
    return torch.where(found, p, 1.0 / light_count)


RIS_CANDIDATES = 4  # M for light_sampling='ris'


def _candidates(w_table, site, light_count: int):
    """RIS_CANDIDATES uniform candidates streamed into an empty reservoir
    with weights p_hat / p_src = p_hat * L (renderer.py:371-384 and
    :429-437 of the JAX package): (site, sel [R] int64 with -1 = empty,
    wsum [R]). The take test divides the rounded product; the sum
    contracts as XLA does: 0 + w0 folds to w0, then w0 + w1 fuses the first
    candidate's product, fma(p0, L, w1), and each later add the new
    one's."""
    sel = torch.full(w_table.shape[:1], -1, dtype=torch.int64,
                     device=w_table.device)
    first = None
    for k in range(RIS_CANDIDATES):
        site, u_cand = rng.rand_unit_float(site)
        cand = _uniform_pick(u_cand, light_count)
        p_hat = w_table.gather(1, cand[:, None])[:, 0]
        w = p_hat * float(light_count)
        if k == 0:
            first, wsum = p_hat, w
        elif k == 1:
            wsum = fma(first, float(light_count), w)
        else:
            wsum = fma(p_hat, float(light_count), wsum)
        site, u_res = rng.rand_unit_float(site)
        take = u_res < torch.div(w, torch.clamp_min(wsum, 1e-30))
        sel = torch.where(take, cand, sel)
    return site, sel, wsum


def _select_light_ris(scene, policy, point: Vec3, site, light_count: int):
    """Resampled importance sampling over lights (the reference's dormant
    RIS hook, Sampling.hpp:25-73, wired into NEE): RIS_CANDIDATES uniform
    candidates re-weighted by the power weights at `point`, one survivor a
    lane. Returns (site, selected [R] int64, W [R]), W the unbiased
    contribution weight that replaces 1/p_select."""
    w_table = _light_selection_weights(scene, point)
    site, sel, wsum = _candidates(w_table, site, light_count)
    ok = sel >= 0
    p_hat_sel = w_table.gather(1, torch.clamp_min(sel, 0)[:, None])[:, 0]
    big_w = torch.where(ok & (p_hat_sel > 0.0), torch.div(
        wsum, RIS_CANDIDATES * torch.clamp_min(p_hat_sel, 1e-30)), 0.0)
    return site, torch.where(ok, sel, 0), big_w


def _restir_key(order: str, width: int, edge: int):
    """The ray-order key of local pixel (x, y): raster y * W + x, or
    tile-major then raster within a tile of edge x edge pixels."""
    if order == "tile":
        tiles_x = -(-width // edge)
        return lambda px, py: (((py // edge) * tiles_x + (px // edge))
                               * (edge * edge) + (py % edge) * edge
                               + (px % edge))
    return lambda px, py: py * width + px


def _select_light_restir(scene, policy, point: Vec3, site, light_count: int,
                         res_in, guides=None, xy=None, geom=None):
    """ReSTIR light selection (renderer.py:397-540 of the JAX package): a
    fresh RIS reservoir merged with the lane's temporal reservoir (the
    pixel's, from the previous pass) and ``restir_spatial`` neighbour
    reservoirs, each re-weighted by the power weight at the current
    `point`; W = wsum / (count * p_hat(sel)).

    Neighbours: with `xy` (the lanes' local pixel coordinates) and `geom`
    (order, width, tile edge, spp), a screen-space neighbour (dx, dy) in the
    ``restir_radius`` box, its lane recovered from the ray-order key
    (``_restir_key``) within this chunk of lanes and verified against the
    gathered lane's own coordinates; `guides` (normal Vec3, hit distance)
    adds the geometry rejection behind ``restir_reject`` (dot of the normals
    >= 0.906, |t - t_nb| <= 0.1 max). Without them, 1-D lane offsets.

    res_in / res_out: (sample [R] int64, -1 = empty; W [R]; count [R]) in
    the lanes' order. Returns (site, selected, W, res_out)."""
    w_table = _light_selection_weights(scene, point)
    device = point.x.device
    m = float(RIS_CANDIDATES)

    def p_hat(cand):
        return w_table.gather(1, torch.clamp_min(cand, 0)[:, None])[:, 0]

    site, sel, wsum = _candidates(w_table, site, light_count)
    cnt = torch.full_like(point.x, m)

    s_in, w_in, c_in = res_in
    cands = [(s_in, w_in, c_in, None)]
    num = s_in.shape[0]
    lane = torch.arange(num, dtype=torch.int64, device=device)
    radius = policy.restir_radius
    span = float(2 * radius + 1)
    use_2d = xy is not None and geom is not None
    reject = False
    if use_2d:
        order, width, edge, spp = geom
        key = _restir_key(order, width, edge)
        x_i, y_i = xy
        key_self = key(x_i, y_i)
        # one packed row a lane: one row gather a candidate
        cols = [s_in, w_in, c_in, x_i, y_i]
        reject = guides is not None and policy.restir_reject
        if reject:
            n_g, d_g = guides
            cols += [n_g.x, n_g.y, n_g.z, d_g]
        nb_tbl = fast_gather.pack_table(*cols)
    for _ in range(policy.restir_spatial):
        if not use_2d:
            site, u_off = rng.rand_unit_float(site)
            off = (u_off * span).to(torch.int64) - radius
            idx = torch.clamp(lane + off, 0, num - 1)
            cands.append((s_in[idx], w_in[idx], c_in[idx], None))
            continue
        site, u_dx = rng.rand_unit_float(site)
        site, u_dy = rng.rand_unit_float(site)
        nx = torch.clamp(x_i + (u_dx * span).to(torch.int64) - radius, 0,
                         width - 1)
        # the top is clamped; the bottom is caught by the coordinate check
        ny = torch.clamp_min(y_i + (u_dy * span).to(torch.int64) - radius, 0)
        idx = torch.clamp(lane + (key(nx, ny) - key_self) * spp, 0, num - 1)
        row = fast_gather.gather_rows(nb_tbl, idx)
        ok2 = ((row[:, 3].to(torch.int64) == nx)
               & (row[:, 4].to(torch.int64) == ny))
        if reject:
            ndot = fp.dot3(n_g.x, n_g.y, n_g.z, row[:, 5], row[:, 6],
                           row[:, 7])
            d_nb = row[:, 8]
            ok2 = ok2 & (ndot >= 0.906) & (
                torch.abs(d_g - d_nb) <= 0.1 * torch.maximum(d_g, d_nb))
        cands.append((row[:, 0].to(torch.int64), row[:, 1], row[:, 2], ok2))

    cap = m * float(policy.restir_temporal_cap)
    for s_q, w_q, c_q, extra_ok in cands:
        c_q = torch.clamp_max(c_q, cap)
        ok_q = s_q >= 0
        if extra_ok is not None:
            ok_q = ok_q & extra_ok
        w = torch.where(ok_q, p_hat(s_q) * w_q * c_q, 0.0)
        wsum = wsum + w
        site, u_res = rng.rand_unit_float(site)
        take = (u_res < torch.div(w, torch.clamp_min(wsum, 1e-30))) & ok_q
        sel = torch.where(take, s_q, sel)
        cnt = cnt + torch.where(ok_q, c_q, 0.0)

    ok = sel >= 0
    p_sel = p_hat(sel)
    big_w = torch.where(ok & (p_sel > 0.0), torch.div(
        wsum, cnt * torch.clamp_min(p_sel, 1e-30)), 0.0)
    res_out = (torch.where(ok, sel, -1), big_w, torch.clamp_max(cnt, cap))
    return site, torch.where(ok, sel, 0), big_w, res_out


def _sphere_light_sample(scene: Scene, selected, n_lights: int, hit, prim_id,
                         is_tri, p_offset: Vec3, t_quat: Quat, t_draw,
                         s_draw):
    """Cone sample of the selected sphere light (Renderer.hpp:258-273):
    (ok, direction, distance, pdf, emission); `ok` is false where the lane
    selected a triangle light, sits on or inside the light, or the whole cone
    lies below the hemisphere."""
    sel_s = torch.clamp(selected, 0, n_lights - 1)
    # one [L, 8] light table (prim id, center, r^2, emission), one row gather
    sl = scene.lights.to(torch.int64)
    sp, em = scene.spheres, scene.materials.emission
    s_mid = sp.material_id[sl].to(torch.int64)
    light_tbl = fast_gather.pack_table(
        sl, sp.center.x[sl], sp.center.y[sl], sp.center.z[sl],
        sp.radius_sq[sl], em.x[s_mid], em.y[s_mid], em.z[s_mid])
    lrow = fast_gather.gather_rows(light_tbl, sel_s)
    light_prim = lrow[:, 0].to(torch.int32)
    lc = Vec3(lrow[:, 1], lrow[:, 2], lrow[:, 3])
    lr_sq = lrow[:, 4]
    wc = lc - p_offset
    center_dist2 = wc.dot(wc)
    ok = (hit & (selected < n_lights)
          & ~((~is_tri) & (light_prim == prim_id))  # self (Renderer.hpp:263)
          & (center_dist2 > lr_sq))  # inside the sphere (:266)
    center_dist = fp.sqrt(center_dist2)
    wc = wc * (1.0 / torch.clamp_min(center_dist, 1e-20))
    sin_theta_max2 = lr_sq / torch.clamp_min(center_dist2, 1e-20)
    # entire cone below the hemisphere (:270-273); rounded as the JAX
    # renderer's jitted bounce_step contracts this call
    n_dot_w = sampling.to_local(t_quat, wc, fuse_xy=True).z
    ok = ok & ~((n_dot_w < 0.0) & (sin_theta_max2 < n_dot_w * n_dot_w))
    dir_s, dist_s, pdf_s = sampling.sample_direction_to_sphere(
        wc, sin_theta_max2, center_dist, lr_sq, t_draw, s_draw)
    return ok, dir_s, dist_s, pdf_s, Vec3(lrow[:, 5], lrow[:, 6], lrow[:, 7])


def _triangle_light_sample(scene: Scene, selected, n_sphere_lights: int, hit,
                           prim_id, is_tri, p_offset: Vec3, t_draw, s_draw):
    """Area sample of the selected triangle light: a uniform point on the
    triangle by the sqrt warp, pdf = dist^2 / (area * cos) in solid angle,
    and a shadow distance that stops short of the light's own surface.
    Returns (ok, direction, distance, pdf, emission); `ok` is false where the
    lane selected a sphere light, sits on that triangle, or sees it edge
    on."""
    n_lights = scene.num_tri_lights
    sel_t = torch.clamp(selected - n_sphere_lights, 0, n_lights - 1)
    tri, em = scene.triangles, scene.materials.emission
    # one [L2, 17] table (index, v0, e1, e2, normal, area, emission)
    tl = scene.tri_lights.to(torch.int64)
    t_mid = tri.material_id[tl].to(torch.int64)
    tri_tbl = fast_gather.pack_table(
        tl, *(c[tl] for v in (tri.v0, tri.e1, tri.e2, tri.normal) for c in v),
        tri.area[tl], em.x[t_mid], em.y[t_mid], em.z[t_mid])
    trow = fast_gather.gather_rows(tri_tbl, sel_t)
    light_tri = trow[:, 0].to(torch.int32)
    v0, e1, e2, ln = (Vec3(trow[:, k], trow[:, k + 1], trow[:, k + 2])
                      for k in (1, 4, 7, 10))
    area = trow[:, 13]
    su = fp.sqrt(torch.clamp_min(t_draw, 0.0))
    a, b = su * (1.0 - s_draw), su * s_draw
    # v0 + e1*a + e2*b contracts to fma(e2, b, fma(e1, a, v0))
    pt = Vec3(*(fma(c2, b, fma(c1, a, c0)) for c0, c1, c2 in zip(v0, e1, e2)))
    to_light = pt - p_offset
    dist2 = to_light.dot(to_light)
    dist = fp.sqrt(torch.clamp_min(dist2, 1e-20))
    dir_t = to_light * (1.0 / dist)
    cos_light = torch.abs(dir_t.dot(ln))
    pdf_t = dist2 / torch.clamp_min(area * cos_light, 1e-9)
    ok = (hit & (selected >= n_sphere_lights)
          & ~(is_tri & (light_tri == prim_id)) & (cos_light > 1e-6))
    shadow_dist = dist - torch.clamp_min(dist * 3e-5, 1e-4)
    return (ok, dir_t, shadow_dist, pdf_t,
            Vec3(trow[:, 14], trow[:, 15], trow[:, 16]))


def _next_event_estimation(scene: Scene, policy: RendererPolicy,
                           state: PathState, accumulation, seeds, hit,
                           prim_id, is_tri, p_offset: Vec3, t_quat: Quat,
                           v_local: Vec3, mat: dict, restir_in=None,
                           restir_xy=None, restir_geom=None,
                           restir_guides=None):
    """NEE with MIS (Renderer.hpp:247-314): pick one light among the sphere
    lights and then the triangle lights (``policy.light_sampling``),
    cone-sample a sphere light or area-sample a triangle light, trace a
    shadow ray, add the power-heuristic-weighted contribution. Under 'ris'
    and 'restir' (more than one light) the RIS weight W replaces 1/p_select
    and there is no MIS. The reference's early rejections become masks.
    Returns (contribution Vec3, shadow rays traced [R] bool, the ReSTIR
    reservoirs out or None)."""
    n_sphere_lights, n_tri_lights = scene.num_lights, scene.num_tri_lights
    light_count = n_sphere_lights + n_tri_lights
    zeros = torch.zeros_like(state.p.x)
    zero3 = Vec3(zeros, zeros, zeros)
    if light_count == 0:
        return zero3, torch.zeros_like(hit), None
    site = _site_state(accumulation, add32(seeds, 2 * state.bounce), policy)
    site, (t_draw, s_draw) = rng.draws(site, 2)
    restir_out = ris_w = light_selection_pdf = None
    if (policy.light_sampling == "restir" and restir_in is not None
            and light_count > 1):
        site, selected, ris_w, restir_out = _select_light_restir(
            scene, policy, p_offset, site, light_count, restir_in,
            guides=restir_guides, xy=restir_xy, geom=restir_geom)
    elif policy.light_sampling in ("ris", "restir") and light_count > 1:
        site, selected, ris_w = _select_light_ris(scene, policy, p_offset,
                                                  site, light_count)
    else:
        site, sel_draw = rng.rand_unit_float(site)
        selected, light_selection_pdf = _select_light(
            scene, policy, p_offset, sel_draw, light_count)

    l_dir, l_dist, l_pdf, l_emission = zero3, zeros, zeros, zero3
    valid = torch.zeros_like(hit)
    samples = []
    if n_sphere_lights > 0:
        samples.append(_sphere_light_sample(
            scene, selected, n_sphere_lights, hit, prim_id, is_tri, p_offset,
            t_quat, t_draw, s_draw))
    if n_tri_lights > 0:
        samples.append(_triangle_light_sample(
            scene, selected, n_sphere_lights, hit, prim_id, is_tri, p_offset,
            t_draw, s_draw))
    for ok, dir_k, dist_k, pdf_k, em_k in samples:
        l_dir = dir_k.where(ok, l_dir)
        l_dist = torch.where(ok, dist_k, l_dist)
        l_pdf = torch.where(ok, pdf_k, l_pdf)
        l_emission = em_k.where(ok, l_emission)
        valid = valid | ok

    # fma(v.z, t.w, v.x*t.y) here, as the JAX renderer's jitted bounce_step
    # contracts this call
    l_local = sampling.to_local(t_quat, l_dir)
    valid = valid & (l_local.z >= 0.0)  # sample below the hemisphere (:276)
    shadow_radiance = (l_emission * state.throughput
                       * _closure_eval(policy, mat, l_local, v_local))
    if ris_w is not None:
        # the RIS estimator f / pdf * W, without MIS: NEE alone carries the
        # direct light in this mode (see _emissive_hit)
        shadow_radiance = shadow_radiance * torch.div(
            ris_w, torch.clamp_min(l_pdf, 1e-9))
    else:
        l_pdf = l_pdf * light_selection_pdf  # (:282)
        brdf_pdf = _closure_pdf(policy, mat, l_local, v_local)
        shadow_radiance = shadow_radiance * sampling.power_heuristic_over_f(
            l_pdf, brdf_pdf)
    valid = valid & (shadow_radiance.max_component() > 0.0)  # (:285)

    # Shadow trace (Renderer.hpp:302-314). Masked-out lanes get tfar = 0,
    # which never occludes.
    occluded = intersect.occluded_scene(
        scene, p_offset, l_dir, torch.where(valid, l_dist, 0.0),
        accel=policy.effective_accel, policy=policy)
    contribution = shadow_radiance.where(valid & ~occluded, zero3)
    return contribution, valid, restir_out


def _emissive_hit(scene: Scene, policy: RendererPolicy, state: PathState,
                  hit, prim_id, is_tri, mat_id, tfar, v_local: Vec3, em: Vec3,
                  prim_extra: dict):
    """Emissive-primitive hit with MIS (Renderer.hpp:319-353). For a sphere
    the distance to the light's center comes from the law of cosines
    (:328-332); for a triangle the light pdf is tfar^2 / (area * |cos|), the
    cosine at the light being the local view vector's z. Under 'ris' and
    'restir' (more than one light) NEE alone carries the direct light: an
    emitter hit counts only where NEE could not have sampled it, on camera
    rays and after a delta bounce. The primary bounce adds emission
    unweighted, so no MIS weight is formed there."""
    is_emissive = hit & (em.max_component() > FLT_EPSILON)
    light_count = scene.num_lights + scene.num_tri_lights
    if policy.light_sampling in ("ris", "restir") and light_count > 1:
        weight = (torch.ones_like(tfar) if state.bounce == 0
                  else torch.where(state.prev_delta, 1.0, 0.0))
    elif not policy.mis or light_count == 0 or state.bounce == 0:
        weight = torch.ones_like(tfar)
    else:
        light_selection_pdf = _hit_light_selection_pdf(
            scene, policy, state, prim_id, is_tri, light_count)
        radius2 = prim_extra["radius_sq"]
        n_dot_v = v_local.z
        center_dist2 = fma(tfar, fma(n_dot_v, 2.0 * fp.sqrt(radius2), tfar),
                           radius2)
        light_pdf = light_selection_pdf * sampling.sphere_pdf(
            radius2, torch.clamp_min(center_dist2, 1e-20))
        if scene.num_tri_lights > 0:
            tri_pdf = light_selection_pdf * (tfar * tfar) / torch.clamp_min(
                prim_extra["area"] * torch.abs(n_dot_v), 1e-9)
            light_pdf = torch.where(is_tri, tri_pdf, light_pdf)
        mis_weight = sampling.power_heuristic(state.prev_pdf, light_pdf)
        # a delta previous bounce could not have been light-sampled
        weight = torch.where(state.prev_delta, 1.0, mis_weight)
    contribution = (state.throughput * em) * weight
    zeros = torch.zeros_like(tfar)
    return contribution.where(is_emissive, Vec3(zeros, zeros, zeros))


def bounce_step(scene: Scene, policy: RendererPolicy, accumulation, seeds,
                state: PathState, restir_in=None, restir_xy=None,
                restir_geom=None):
    """One wavefront bounce (Renderer.hpp:131-432). With `restir_in` (the
    lanes' ReSTIR reservoirs, ``_select_light_restir``) it returns
    (PathState, reservoirs out); where NEE forms none (one light, or
    ``mis=False``) the reservoirs pass through."""
    # ---- INTERSECTION (Renderer.hpp:165): the closest-hit battery ----
    tfar, prim_id, is_tri = intersect.intersect_scene(
        scene, state.p, state.d, accel=policy.effective_accel,
        alive=state.alive, policy=policy)
    hit = state.alive & (prim_id >= 0)
    miss = state.alive & (prim_id < 0)

    # ---- CLOSEST HIT (:169-214) ----
    p_offset, n, t_quat, v_local, mat_id, backface, hit_pt, prim_extra = (
        _closest_hit_frame(scene, state, tfar, prim_id, is_tri))
    mat = _gather_material(scene, policy, mat_id)

    radiance = state.radiance

    # ---- NEE + SHADOW (:247-314): the any-hit battery ----
    shadow_traced = torch.zeros_like(hit)
    restir_out = None
    if policy.mis:
        nee, shadow_traced, restir_out = _next_event_estimation(
            scene, policy, state, accumulation, seeds, hit, prim_id, is_tri,
            p_offset, t_quat, v_local, mat, restir_in=restir_in,
            restir_xy=restir_xy, restir_geom=restir_geom,
            restir_guides=None if restir_in is None else (n, tfar))
        radiance = radiance + nee

    # ---- EMISSIVE HIT (:319-353) ----
    radiance = radiance + _emissive_hit(
        scene, policy, state, hit, prim_id, is_tri, mat_id, tfar, v_local,
        em=mat["emission"], prim_extra=prim_extra)

    # ---- BRDF SAMPLE + RUSSIAN ROULETTE (:357-404) ----
    site = _site_state(accumulation, add32(seeds, 2 * state.bounce + 1),
                       policy)
    if policy.brdf == "principled":
        # draw order: lobe, u, v, fresnel, rr
        site, (lobe_draw, u_draw, v_draw, fres_draw, rr_draw) = rng.draws(
            site, 5)
        bs = closures.principled_sample(
            mat["albedo"], mat["f0"], mat["transmission"], mat["alpha"],
            mat["ior"], ~backface, v_local, lobe_draw, u_draw, v_draw,
            fres_draw, mat.get("f80"))
        bsdf_delta = bs.is_delta
    else:
        site, (u_draw, v_draw, rr_draw) = rng.draws(site, 3)
        if policy.brdf == "lambertian":
            bs = closures.lambert_sample(mat["albedo"], v_local, u_draw,
                                         v_draw)
        else:
            bs = closures.ggx_sample(mat["f0"], mat["alpha"], v_local, u_draw,
                                     v_draw, mat.get("f80"))
        bsdf_delta = torch.zeros_like(hit)
    bsdf_dir, bsdf_est = bs.direction, bs.estimator
    new_throughput = state.throughput * bsdf_est
    if policy.russian_roulette:
        q = 1.0 - new_throughput.max_component()
        rr_kill = rr_draw < q
        new_throughput = new_throughput * (
            1.0 / torch.clamp_min(1.0 - q, FLT_EPSILON))
    else:
        rr_kill = torch.zeros_like(hit)
    world_dir = sampling.to_world(t_quat, bsdf_dir)
    if policy.brdf == "principled":
        # XLA recomputes the sample in the fusion of each world lane, and
        # the x lane's rounds the specular lobe otherwise
        world_dir = Vec3(sampling.to_world(t_quat, bs.direction_x).x,
                         world_dir.y, world_dir.z)
    # pdf of the sampled direction in the local frame, for next-bounce MIS
    next_pdf = _closure_pdf(policy, mat, bsdf_dir, v_local)
    p_next = p_offset
    if policy.brdf == "principled":
        # transmitted rays leave from below the surface: the scale-aware
        # offset mirrored to the other side
        p_below = hit_pt - (p_offset - hit_pt)
        p_next = p_below.where(bsdf_dir.z < 0.0, p_offset)

    # ---- MISS / SKY (:408-420) ----
    sky = scene.sky.sample(state.d)
    thr = state.throughput
    if policy.sky_bug_compat:
        # reference bug: all channels scaled by throughput.r (:416-418)
        sky_contrib = Vec3(thr.x * sky.x, thr.x * sky.y, thr.x * sky.z)
    else:
        sky_contrib = thr * sky
    sky_on = miss & scene.sky.has_ambient()
    zeros = torch.zeros_like(radiance.x)
    radiance = radiance + sky_contrib.where(sky_on, Vec3(zeros, zeros, zeros))

    alive_next = hit & ~rr_kill
    if state.bounce + 1 >= policy.max_bounces:
        alive_next = torch.zeros_like(alive_next)
    rays_this_bounce = state.alive.sum() + shadow_traced.sum()
    out = PathState(
        bounce=state.bounce + 1,
        p=p_next.where(alive_next, state.p),
        d=world_dir.where(alive_next, state.d),
        throughput=new_throughput.where(alive_next, state.throughput),
        radiance=radiance,
        prev_pdf=torch.where(alive_next, next_pdf, state.prev_pdf),
        prev_delta=torch.where(alive_next, bsdf_delta, state.prev_delta),
        alive=alive_next,
        ray_count=add32(state.ray_count, rays_this_bounce),
    )
    if restir_in is not None:
        return out, restir_in if restir_out is None else restir_out
    return out


def initial_state(p0: Vec3, d0: Vec3, alive0=None) -> PathState:
    """Bounce-0 wavefront state for camera rays; `alive0` masks lanes that
    start dead (chunk padding)."""
    zero = torch.zeros_like(p0.x)
    one = torch.ones_like(p0.x)
    alive = (torch.ones_like(p0.x, dtype=torch.bool) if alive0 is None
             else alive0.clone())
    return PathState(
        bounce=0, p=p0, d=d0, throughput=Vec3(one, one, one),
        radiance=Vec3(zero, zero, zero), prev_pdf=zero,
        prev_delta=torch.zeros_like(alive), alive=alive,
        ray_count=torch.zeros((), dtype=torch.int64, device=p0.x.device))


def _narrow_caps(policy: RendererPolicy, scene: Scene, num_rays: int):
    """Widths of the narrowing cascade: num_rays / f for each narrow factor,
    rounded up to 2048 lanes, strictly decreasing."""
    caps = []
    if narrowing_on(policy, scene):
        for f in policy.narrow_factors:
            cap = -(-(num_rays // f) // 2048) * 2048
            if 0 < cap < (caps[-1] if caps else num_rays):
                caps.append(cap)
    return caps


def narrow_state(state: PathState, cap: int):
    """Move the alive lanes of `state` to the front, stably, and keep the
    first `cap` lanes: (narrow state, keep [cap] int64 = the full-width lane
    of each narrow lane, inv [R] int64 = the compacted position of each
    full-width lane)."""
    order, inv = compact_order(state.alive)
    keep = order[:cap].to(torch.int64)

    def take(a):
        return a[keep]

    narrow = PathState(
        bounce=state.bounce, p=Vec3(*map(take, state.p)),
        d=Vec3(*map(take, state.d)),
        throughput=Vec3(*map(take, state.throughput)),
        radiance=Vec3(*map(take, state.radiance)),
        prev_pdf=take(state.prev_pdf), prev_delta=take(state.prev_delta),
        alive=take(state.alive), ray_count=state.ray_count)
    return narrow, keep, inv.to(torch.int64)


def trace_rays(scene: Scene, policy: RendererPolicy, accumulation, seeds,
               p0: Vec3, d0: Vec3, alive0=None, res_in=None, restir_xy=None,
               restir_geom=None):
    """The bounce loop for one chunk of primary rays (Renderer.hpp:131-432):
    (radiance Vec3 [R], ray_count), and the reservoirs out as a third item
    where `res_in` is given. Stops at max_bounces or when no lane is alive;
    the liveness test reads one number back per bounce.

    ``policy.primary_accel`` peels the primary bounce out of the loop and
    runs it under that backend: every backend returns the same hits and the
    RNG is keyed by the bounce, not by the loop. Under 'restir' with
    reservoirs `res_in` the primary bounce is peeled too: it is the only
    bounce that reuses reservoirs.

    Narrowing cascade (``narrow_wavefront``): full-width masked bounces run
    until the live lanes fit 1/f of the width, then the alive lanes move to
    the front of a narrower wavefront (stable: survivors keep their order,
    so the traversal's tiles stay coherent) and the loop goes on there; once
    per narrow factor. Each lane's radiance and the ray count are those of
    the full-width loop."""
    state = initial_state(p0, d0, alive0)
    pol0 = policy
    if policy.primary_accel and policy.primary_accel != policy.effective_accel:
        pol0 = dataclasses.replace(policy, accel=policy.primary_accel,
                                   use_bvh=False)
    res_out = None
    if res_in is not None and policy.light_sampling == "restir":
        state, res_out = bounce_step(scene, pol0, accumulation, seeds, state,
                                     restir_in=res_in, restir_xy=restir_xy,
                                     restir_geom=restir_geom)
    elif pol0 is not policy:
        state = bounce_step(scene, pol0, accumulation, seeds, state)

    restores = []
    for cap in _narrow_caps(policy, scene, p0.x.shape[0]):
        while (state.bounce < policy.max_bounces
               and int(state.alive.sum()) > cap):
            state = bounce_step(scene, policy, accumulation, seeds, state)
        full_radiance = state.radiance
        state, keep, inv = narrow_state(state, cap)
        restores.append((inv, cap, full_radiance))
        seeds = seeds[keep]
        if isinstance(accumulation, torch.Tensor) and accumulation.dim() >= 1:
            # per-lane accumulation indices (render_pass k_passes > 1)
            accumulation = accumulation[keep]

    while state.bounce < policy.max_bounces and bool(state.alive.any()):
        state = bounce_step(scene, policy, accumulation, seeds, state)
    radiance = state.radiance
    for inv, cap, prev_rad in reversed(restores):
        # lane i went to narrow row inv[i] where inv[i] < cap; the lanes
        # left behind were dead and keep their full-width value
        live = inv < cap
        back = torch.clamp_max(inv, cap - 1)
        radiance = Vec3(*(torch.where(live, c[back], pc)
                          for c, pc in zip(radiance, prev_rad)))
    if res_in is not None:
        return radiance, state.ray_count, res_out
    return radiance, state.ray_count


@functools.lru_cache(maxsize=32)
def _tile_pixel_order_np(width: int, npix: int, tile: int = 16):
    """Static position -> pixel permutation visiting tile x tile screen
    blocks in raster order, raster within each block (the reference's tile
    decomposition, Renderer.hpp:75, as a ray-processing order): each
    traversal tile then covers one compact screen block. None when the flat
    range is not a whole number of scanlines."""
    if npix % width:
        return None
    xs = np.arange(npix, dtype=np.int64) % width
    ys = np.arange(npix, dtype=np.int64) // width
    tiles_x = -(-width // tile)
    key = ((ys // tile) * tiles_x + (xs // tile)) * (tile * tile) \
        + (ys % tile) * tile + (xs % tile)
    return np.argsort(key, kind="stable").astype(np.int64)


@functools.lru_cache(maxsize=8)
def _tile_pixel_order(width: int, npix: int, tile: int, device):
    """``_tile_pixel_order_np`` and its inverse (pixel -> position) as int64
    tensors on `device`, made once per frame shape: (perm, inv), or None
    where there is no such order."""
    perm = _tile_pixel_order_np(width, npix, tile)
    if perm is None:
        return None
    return (torch.from_numpy(perm).to(device),
            torch.from_numpy(np.argsort(perm)).to(device))


def sum_rows(rows):
    """The rows of `rows` (its first dimension) added in order, as XLA
    reduces a short axis."""
    total = rows[0]
    for row in rows[1:]:
        total = total + row
    return total


def render_pass(scene: Scene, policy: RendererPolicy, accumulation,
                width: int, height: int, pixel_start: int = 0,
                npix: int = None, k_passes: int = 1, restir_in=None):
    """One progressive sample for a contiguous flat-pixel range: (radiance
    Vec3 of [npix] tensors in raster order, row 0 = bottom scanline;
    ray_count, a 0-d u32 in int64). Rays are traced in raster order or, with
    ``ray_order='tile'`` ('auto' under accel='pallas'), in screen-tile order,
    and the radiance is put back into raster order.

    With ``samples_per_pixel`` = spp > 1 each pixel traces spp rays on
    consecutive lanes, seeded by path * spp + sample, and the radiance is
    their sum. Rays go through ``trace_rays`` in ``rays_per_chunk``
    chunks; the last chunk is padded with lanes that are dead from bounce
    0. With
    ``k_passes > 1`` the k consecutive passes accumulation .. accumulation
    + k - 1 are traced as one wide wavefront and the radiance comes back as
    [k, npix] rows, each bit-identical to its sequential pass (the counter
    RNG keys every draw by accumulation and pixel).

    ``restir_in`` ([3, npix] float32 in raster pixel order: light index, -1
    = empty; W; count) carries the per-pixel ReSTIR reservoirs under
    ``light_sampling='restir'``; the return is then (radiance, ray_count,
    reservoirs out [3, npix]), each pixel's from its first sample's lane.
    The reservoirs chain pass to pass, so k_passes must be 1."""
    check_policy(policy)
    device = scene.device
    if npix is None:
        npix = width * height
    spp = policy.samples_per_pixel
    per_pass = npix * spp
    nrays = per_pass * k_passes
    ray = torch.arange(nrays, dtype=torch.int64, device=device)
    ray_order = policy.ray_order
    if ray_order == "auto":
        ray_order = ("tile" if "pallas" in (policy.effective_accel,
                                            policy.primary_accel)
                     else "raster")
    order = None
    if ray_order == "tile":
        # block edge matched to the traversal tile: one tile of
        # pallas_tile_rays rays covers one square screen block
        tile_rays = policy.pallas_tile_rays
        edge = (16 if tile_rays == "auto"
                else max(8, math.isqrt(max(tile_rays, 64))))
        order = _tile_pixel_order(width, npix, edge, torch.device(device))
    # lane = (pass, position, sample): the spp samples of a pixel are
    # consecutive lanes
    r_in_pass = ray % per_pass if k_passes > 1 else ray
    pos = r_in_pass // spp
    if order is not None:
        pos = order[0][pos]
    i = (pixel_start + pos) & MASK
    x = i % width
    y = i // width
    seeds = pixel_seeds_from_index(i, width, policy, r_in_pass % spp)
    accumulation = accumulation & MASK
    acc_lane = (add32(accumulation, ray // per_pass) if k_passes > 1
                else None)

    chunk = min(policy.rays_per_chunk, nrays)
    padded = -(-nrays // chunk) * chunk

    def pad(a, value=0):
        return torch.cat([a, torch.full((padded - nrays,), value,
                                        dtype=a.dtype, device=device)])

    use_restir = restir_in is not None and policy.light_sampling == "restir"
    assert not (use_restir and k_passes > 1), (
        "ReSTIR reservoirs chain pass to pass: k_passes must be 1")
    if use_restir:
        # each lane takes its pixel's reservoir, and its local pixel
        # coordinates, which the 2-D neighbourhood inverts
        res_pos = (pad(restir_in[0][pos].to(torch.int64), -1),
                   pad(restir_in[1][pos]), pad(restir_in[2][pos]))
        res_xy = (pad(pos % width), pad(pos // width))
        restir_geom = None
        if policy.restir_spatial_2d:
            restir_geom = (("tile", width, edge, spp) if order is not None
                           else ("raster", width, 0, spp))
    lane_ok = pad(torch.ones(nrays, dtype=torch.bool, device=device))
    xs, ys, ss = pad(x), pad(y), pad(seeds)
    accs = pad(acc_lane) if acc_lane is not None else None
    rads, res_chunks, count = [], [], 0
    for start in range(0, padded, chunk):
        sl = slice(start, start + chunk)
        acc = accs[sl] if accs is not None else accumulation
        p0, d0 = generate_camera_rays(scene.camera, xs[sl], ys[sl], acc,
                                      ss[sl], policy.enable_dof, policy)
        if use_restir:
            rad, cnt, res = trace_rays(
                scene, policy, acc, ss[sl], p0, d0, alive0=lane_ok[sl],
                res_in=tuple(a[sl] for a in res_pos),
                restir_xy=(tuple(a[sl] for a in res_xy) if restir_geom
                           else None),
                restir_geom=restir_geom)
            res_chunks.append(res)
        else:
            rad, cnt = trace_rays(scene, policy, acc, ss[sl], p0, d0,
                                  alive0=lane_ok[sl])
        rads.append(rad)
        count = add32(cnt, count)
    flat = Vec3(*(torch.cat([r[k] for r in rads])[:nrays] for k in range(3)))
    if policy.clamp_radiance:
        flat = Vec3(*(torch.clamp_max(c, policy.max_radiance) for c in flat))
    if spp > 1:
        # the per-pixel sum over the pass's spp samples, in lane order as
        # XLA reduces them; the resolve divides by spp
        flat = Vec3(*(sum_rows(c.reshape(-1, spp).T) for c in flat))
    if k_passes > 1:
        flat = Vec3(*(c.reshape(k_passes, npix) for c in flat))
    if order is not None:  # back to raster pixel order
        flat = Vec3(*(c[..., order[1]] for c in flat))
    if use_restir:
        # the reservoirs back to raster pixel order, a pixel's first sample's
        rs = [torch.cat([r[k] for r in res_chunks])[:nrays] for k in range(3)]
        if spp > 1:
            rs = [a.reshape(npix, spp)[:, 0] for a in rs]
        if order is not None:
            rs = [a[order[1]] for a in rs]
        return flat, count, torch.stack([rs[0].to(torch.float32), rs[1],
                                         rs[2]])
    return flat, count


def render_pass_pixels(scene: Scene, policy: RendererPolicy, accumulation,
                       width: int, pixel_ids: torch.Tensor,
                       valid: torch.Tensor):
    """One progressive sample for an arbitrary pixel subset, the basis of
    per-pixel adaptive sample allocation (``_trace_rays_masked`` of the JAX
    package's renderer.py:1441-1506): `pixel_ids` [N] flat pixel indices,
    `valid` [N] bool; invalid entries (padding, any id) trace as lanes dead
    from bounce 0 and contribute nothing. Seeds are keyed by (pixel,
    accumulation) as in the dense pass, with the sample index of
    ``pixel_seeds_from_index``'s default: one ray a pixel, whatever
    ``samples_per_pixel`` says, as in the JAX package. No radiance clamp
    and no ReSTIR reservoirs: under 'restir' NEE takes the RIS selection.
    Returns (radiance Vec3 [N] in the order of `pixel_ids`, ray_count).

    The lanes go through ``trace_rays`` in ``rays_per_chunk`` chunks, the
    last one padded with dead lanes: a lane's radiance is that of the JAX
    package's one masked loop over all N lanes, bit for bit (no lane reads
    another, and narrowing leaves each lane's value as it is)."""
    check_policy(policy)
    device = scene.device
    ids = pixel_ids.to(device=device, dtype=torch.int64) & MASK
    alive = valid.to(device=device, dtype=torch.bool)
    n = ids.shape[0]
    seeds = pixel_seeds_from_index(ids, width, policy)
    accumulation = accumulation & MASK
    chunk = min(policy.rays_per_chunk, n)
    padded = -(-n // chunk) * chunk

    def pad(a, value=0):
        return torch.cat([a, torch.full((padded - n,), value, dtype=a.dtype,
                                        device=device)])

    ids, seeds, alive = pad(ids), pad(seeds), pad(alive, False)
    rads, count = [], 0
    for start in range(0, padded, chunk):
        sl = slice(start, start + chunk)
        p0, d0 = generate_camera_rays(scene.camera, ids[sl] % width,
                                      ids[sl] // width, accumulation,
                                      seeds[sl], policy.enable_dof, policy)
        rad, cnt = trace_rays(scene, policy, accumulation, seeds[sl], p0, d0,
                              alive0=alive[sl])
        rads.append(rad)
        count = add32(cnt, count)
    return Vec3(*(torch.cat([r[k] for r in rads])[:n] for k in range(3))), \
        count
