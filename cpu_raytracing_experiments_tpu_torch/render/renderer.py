"""The wavefront path tracer, ported from the JAX package's
``render/renderer.py`` for scenes of spheres and triangles under
``accel='brute'`` and ``accel='pallas'``.

Structure of one bounce (``bounce_step``, Renderer.hpp:131-432): intersect
(the closest-hit battery, or the clustered traversal) -> closest-hit frame
-> NEE with MIS and a shadow any-hit -> emissive hit with MIS -> lambertian
sample + Russian roulette -> miss/sky. ``trace_rays`` runs bounces over one
chunk of rays as a Python loop with mask-based termination: it stops at
``max_bounces`` or when no lane is alive, and with narrowing on it compacts
the live lanes to the front of a narrower wavefront once they fit.
``render_pass`` generates camera rays in raster or screen-tile order and
walks ``rays_per_chunk`` chunks; the padding lanes of the last chunk are
dead from bounce 0.

RNG is the counter scheme of ``core/rng.py``, bit for bit the JAX package's,
so both packages draw the same numbers at every decision point. Knobs
outside this port slice raise ``NotImplementedError`` (``check_policy``).
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
from ..ops.kernels.cluster_traverse import compact_order
from ..scene.scene import Scene
from ..utils.config import RendererPolicy

FLT_EPSILON = 1.1920928955078125e-07  # float32(1.1920929e-7)


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


def check_policy(policy: RendererPolicy, scene: Scene = None):
    """Refuse every knob this port does not render, by name and before any
    work, so that no knob silently changes the result.

    ``accel`` / ``primary_accel`` may be 'brute' or 'pallas'. Of the pallas_*
    knobs, ``pallas_tile_rays``, ``pallas_compact``, ``pallas_stream`` and
    ``pallas_mxu`` act as in the JAX package (``RendererPolicy`` itself
    refuses ``pallas_stream=True`` together with ``pallas_mxu``; a pack of
    fewer than 128 prims a cluster switches both off for itself).
    ``pallas_unroll``, ``pallas_fuse``, ``pallas_trav_block``,
    ``pallas_exit_refresh``, ``pallas_prefetch`` and ``pallas_plan_block``
    are accepted and change nothing: they choose among TPU schedules that
    the JAX package's tests hold bit-identical, and the CUDA kernels have one
    schedule. ``pallas_interpret`` is accepted and ignored likewise. The
    options that are not ported are refused: any ``pallas_plan`` but 'ray' /
    'auto', ``pallas_sort_impl='xla'`` and ``pallas_sort_visits=False``.
    So is a scene whose spheres or triangles are cut into more clusters than
    the planner kernel sorts in one block
    (``cluster_traverse.max_plan_clusters``: 16,384)."""
    accels = {policy.effective_accel, policy.primary_accel or "brute"}
    refused = {
        f"accel={policy.effective_accel!r}":
            policy.effective_accel not in ("brute", "pallas"),
        f"primary_accel={policy.primary_accel!r}":
            policy.primary_accel not in (None, "brute", "pallas"),
        f"brdf={policy.brdf!r}": policy.brdf != "lambertian",
        f"light_sampling={policy.light_sampling!r}":
            policy.light_sampling != "uniform",
        "enable_dof": policy.enable_dof,
        "stratify_camera": policy.stratify_camera,
        "rng_scramble": policy.rng_scramble,
        f"samples_per_pixel={policy.samples_per_pixel}":
            policy.samples_per_pixel != 1,
    }
    if "pallas" in accels:
        refused.update({
            f"pallas_plan={policy.pallas_plan!r}":
                policy.pallas_plan not in ("ray", "auto"),
            "pallas_sort_impl='xla'": policy.pallas_sort_impl != "kernel",
            "pallas_sort_visits=False": not policy.pallas_sort_visits,
        })
    if scene is not None and "pallas" in accels:
        for cp in (scene.sphere_clusters, scene.tri_clusters):
            if cp is None:
                continue
            most = intersect.max_clusters(policy, cp)
            refused[f"accel='pallas' on {cp.num_clusters} clusters of "
                    f"{cp.kind}s (the planner kernel takes {most}; build "
                    "with a larger cluster_size)"] = cp.num_clusters > most
    what = [k for k, bad in refused.items() if bad]
    if what:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(what))


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


def _site_state(accumulation, counter):
    """RNG site state (Renderer.hpp:117/255/362)."""
    return rng.hash_2d(accumulation, counter)


def generate_camera_rays(camera, x, y, accumulation, seeds, enable_dof: bool,
                         policy=None) -> Tuple[Vec3, Vec3]:
    """Primary rays (Camera.hpp:80-88 + Renderer.hpp:113-127), pinhole.
    Returns contiguous [R] components, the layout the batteries take."""
    if enable_dof or (policy is not None and (policy.stratify_camera
                                              or policy.rng_scramble)):
        raise NotImplementedError(
            "enable_dof / stratify_camera / rng_scramble are not ported yet")
    state = _site_state(accumulation, seeds)
    state, ds = rng.draws(state, 2)
    vx = x.to(torch.float32) + ds[0] - camera.half_width
    vy = y.to(torch.float32) + ds[1] - camera.half_height
    # view_dir.z is one scalar for the whole batch: XLA squares it once,
    # outside the elementwise loop, so only x*x + y*y of |v|^2 contracts
    len_sq = fma(vx, vx, vy * vy) + camera.z * camera.z
    inv = fp.rsqrt(torch.clamp_min(len_sq, 1e-30))
    view_dir = Vec3(vx * inv, vy * inv, camera.z * inv)
    origin = Vec3(*(c.expand(vx.shape).contiguous() for c in camera.pos))
    return origin, camera.orient.rotate(view_dir)


def _closest_hit_frame(scene: Scene, state: PathState, tfar, prim_id, is_tri):
    """Closest-hit shading inputs (Renderer.hpp:169-214): offset hit point,
    backface-flipped normal, tangent quat, local view vector, material id.
    Ids are clamped before the gather: a miss (-1) must not index."""
    safe_sphere = torch.clamp_min(torch.where(is_tri, 0, prim_id), 0)
    hit_pt = Vec3(*(fma(dc, tfar, pc) for dc, pc in zip(state.d, state.p)))
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
    v_local = sampling.to_local(t, -state.d)
    # scale-aware normal offset against self-intersection
    eps = torch.clamp_min(3e-5 * torch.maximum(
        torch.abs(hit_pt.x),
        torch.maximum(torch.abs(hit_pt.y), torch.abs(hit_pt.z))), 1e-4)
    p_offset = Vec3(*(fma(nc, eps, hc) for nc, hc in zip(n, hit_pt)))
    return p_offset, n, t, v_local, mat_id, backface, hit_pt, prim_extra


def _select_light(scene: Scene, policy: RendererPolicy, point: Vec3, f,
                  light_count: int):
    """Uniform light selection from one unit draw, bit-identical to the
    reference's rand_bounded_int (Random.hpp:31-34): (selected [R] int64,
    selection pdf)."""
    sel = torch.clamp_max((f * float(light_count)).to(torch.int64),
                          light_count - 1)
    return sel, 1.0 / light_count


def _hit_light_selection_pdf(scene, policy, state, prim_id, is_tri,
                             light_count):
    """Selection pdf the previous shading point would have used for the hit
    light; uniform selection makes it 1/L."""
    return 1.0 / light_count


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
    # entire cone below the hemisphere (:270-273)
    n_dot_w = sampling.to_local(t_quat, wc).z
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
                           v_local: Vec3, mat: dict):
    """NEE with MIS (Renderer.hpp:247-314): pick one light uniformly among
    the sphere lights and then the triangle lights, cone-sample a sphere
    light or area-sample a triangle light, trace a shadow ray, add the
    power-heuristic-weighted contribution. The reference's early rejections
    become masks. Returns (contribution Vec3, shadow rays traced [R] bool)."""
    n_sphere_lights, n_tri_lights = scene.num_lights, scene.num_tri_lights
    light_count = n_sphere_lights + n_tri_lights
    zeros = torch.zeros_like(state.p.x)
    zero3 = Vec3(zeros, zeros, zeros)
    if light_count == 0:
        return zero3, torch.zeros_like(hit)
    site = _site_state(accumulation, add32(seeds, 2 * state.bounce))
    site, (t_draw, s_draw) = rng.draws(site, 2)
    site, sel_draw = rng.rand_unit_float(site)
    selected, light_selection_pdf = _select_light(scene, policy, p_offset,
                                                  sel_draw, light_count)

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

    l_local = sampling.to_local(t_quat, l_dir)
    valid = valid & (l_local.z >= 0.0)  # sample below the hemisphere (:276)
    shadow_radiance = (l_emission * state.throughput
                       * closures.lambert_eval(mat["albedo"], l_local, v_local))
    l_pdf = l_pdf * light_selection_pdf  # (:282)
    brdf_pdf = closures.lambert_pdf(l_local)
    shadow_radiance = shadow_radiance * sampling.power_heuristic_over_f(
        l_pdf, brdf_pdf)
    valid = valid & (shadow_radiance.max_component() > 0.0)  # (:285)

    # Shadow trace (Renderer.hpp:302-314). Masked-out lanes get tfar = 0,
    # which never occludes.
    occluded = intersect.occluded_scene(
        scene, p_offset, l_dir, torch.where(valid, l_dist, 0.0),
        accel=policy.effective_accel, policy=policy)
    contribution = shadow_radiance.where(valid & ~occluded, zero3)
    return contribution, valid


def _emissive_hit(scene: Scene, policy: RendererPolicy, state: PathState,
                  hit, prim_id, is_tri, mat_id, tfar, v_local: Vec3, em: Vec3,
                  prim_extra: dict):
    """Emissive-primitive hit with MIS (Renderer.hpp:319-353). For a sphere
    the distance to the light's center comes from the law of cosines
    (:328-332); for a triangle the light pdf is tfar^2 / (area * |cos|), the
    cosine at the light being the local view vector's z."""
    is_emissive = hit & (em.max_component() > FLT_EPSILON)
    light_count = scene.num_lights + scene.num_tri_lights
    if not policy.mis or light_count == 0:
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
        mis_weight = torch.where(state.prev_delta, 1.0, mis_weight)
        # bounce 0 was BRDF-blind: add emission unweighted (:344-353)
        weight = mis_weight if state.bounce > 0 else torch.ones_like(tfar)
    contribution = (state.throughput * em) * weight
    zeros = torch.zeros_like(tfar)
    return contribution.where(is_emissive, Vec3(zeros, zeros, zeros))


def bounce_step(scene: Scene, policy: RendererPolicy, accumulation, seeds,
                state: PathState) -> PathState:
    """One wavefront bounce (Renderer.hpp:131-432)."""
    # ---- INTERSECTION (Renderer.hpp:165): the closest-hit battery ----
    tfar, prim_id, is_tri = intersect.intersect_scene(
        scene, state.p, state.d, accel=policy.effective_accel,
        alive=state.alive, policy=policy)
    hit = state.alive & (prim_id >= 0)
    miss = state.alive & (prim_id < 0)

    # ---- CLOSEST HIT (:169-214) ----
    p_offset, n, t_quat, v_local, mat_id, backface, hit_pt, prim_extra = (
        _closest_hit_frame(scene, state, tfar, prim_id, is_tri))
    mt = scene.materials
    ax, ay, az, ex, ey, ez = fast_gather.gather_cols(
        mat_id, mt.albedo.x, mt.albedo.y, mt.albedo.z,
        mt.emission.x, mt.emission.y, mt.emission.z)
    mat = {"albedo": Vec3(ax, ay, az), "emission": Vec3(ex, ey, ez)}

    radiance = state.radiance

    # ---- NEE + SHADOW (:247-314): the any-hit battery ----
    shadow_traced = torch.zeros_like(hit)
    if policy.mis:
        nee, shadow_traced = _next_event_estimation(
            scene, policy, state, accumulation, seeds, hit, prim_id, is_tri,
            p_offset, t_quat, v_local, mat)
        radiance = radiance + nee

    # ---- EMISSIVE HIT (:319-353) ----
    radiance = radiance + _emissive_hit(
        scene, policy, state, hit, prim_id, is_tri, mat_id, tfar, v_local,
        em=mat["emission"], prim_extra=prim_extra)

    # ---- BRDF SAMPLE + RUSSIAN ROULETTE (:357-404) ----
    site = _site_state(accumulation, add32(seeds, 2 * state.bounce + 1))
    site, (u_draw, v_draw, rr_draw) = rng.draws(site, 3)
    bs = closures.lambert_sample(mat["albedo"], v_local, u_draw, v_draw)
    bsdf_dir, bsdf_est = bs.direction, bs.estimator
    bsdf_delta = torch.zeros_like(hit)
    new_throughput = state.throughput * bsdf_est
    if policy.russian_roulette:
        q = 1.0 - new_throughput.max_component()
        rr_kill = rr_draw < q
        new_throughput = new_throughput * (
            1.0 / torch.clamp_min(1.0 - q, FLT_EPSILON))
    else:
        rr_kill = torch.zeros_like(hit)
    world_dir = sampling.to_world(t_quat, bsdf_dir)
    # pdf of the sampled direction in the local frame, for next-bounce MIS
    next_pdf = closures.lambert_pdf(bsdf_dir)

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
    return PathState(
        bounce=state.bounce + 1,
        p=p_offset.where(alive_next, state.p),
        d=world_dir.where(alive_next, state.d),
        throughput=new_throughput.where(alive_next, state.throughput),
        radiance=radiance,
        prev_pdf=torch.where(alive_next, next_pdf, state.prev_pdf),
        prev_delta=torch.where(alive_next, bsdf_delta, state.prev_delta),
        alive=alive_next,
        ray_count=add32(state.ray_count, rays_this_bounce),
    )


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
               p0: Vec3, d0: Vec3, alive0=None):
    """The bounce loop for one chunk of primary rays (Renderer.hpp:131-432):
    (radiance Vec3 [R], ray_count). Stops at max_bounces or when no lane is
    alive; the liveness test reads one number back per bounce.

    ``policy.primary_accel`` peels the primary bounce out of the loop and
    runs it under that backend: every backend returns the same hits and the
    RNG is keyed by the bounce, not by the loop.

    Narrowing cascade (``narrow_wavefront``): full-width masked bounces run
    until the live lanes fit 1/f of the width, then the alive lanes move to
    the front of a narrower wavefront (stable: survivors keep their order,
    so the traversal's tiles stay coherent) and the loop goes on there; once
    per narrow factor. Each lane's radiance and the ray count are those of
    the full-width loop."""
    state = initial_state(p0, d0, alive0)
    if policy.primary_accel and policy.primary_accel != policy.effective_accel:
        pol0 = dataclasses.replace(policy, accel=policy.primary_accel,
                                   use_bvh=False)
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


def render_pass(scene: Scene, policy: RendererPolicy, accumulation,
                width: int, height: int, pixel_start: int = 0,
                npix: int = None, k_passes: int = 1):
    """One progressive sample for a contiguous flat-pixel range: (radiance
    Vec3 of [npix] tensors in raster order, row 0 = bottom scanline;
    ray_count, a 0-d u32 in int64). Rays are traced in raster order or, with
    ``ray_order='tile'`` ('auto' under accel='pallas'), in screen-tile order,
    and the radiance is put back into raster order.

    Rays go through ``trace_rays`` in ``rays_per_chunk`` chunks; the last
    chunk is padded with lanes that are dead from bounce 0. With
    ``k_passes > 1`` the k consecutive passes accumulation .. accumulation
    + k - 1 are traced as one wide wavefront and the radiance comes back as
    [k, npix] rows, each bit-identical to its sequential pass (the counter
    RNG keys every draw by accumulation and pixel)."""
    check_policy(policy, scene)
    device = scene.device
    if npix is None:
        npix = width * height
    nrays = npix * k_passes
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
    pos = ray % npix if k_passes > 1 else ray
    if order is not None:
        pos = order[0][pos]
    i = (pixel_start + pos) & MASK
    x = i % width
    y = i // width
    seeds = pixel_seeds_from_index(i, width, policy)
    accumulation = accumulation & MASK
    acc_lane = (add32(accumulation, ray // npix) if k_passes > 1 else None)

    chunk = min(policy.rays_per_chunk, nrays)
    padded = -(-nrays // chunk) * chunk

    def pad(a):
        return torch.cat([a, torch.zeros(padded - nrays, dtype=a.dtype,
                                         device=device)])

    lane_ok = pad(torch.ones(nrays, dtype=torch.bool, device=device))
    xs, ys, ss = pad(x), pad(y), pad(seeds)
    accs = pad(acc_lane) if acc_lane is not None else None
    rads, count = [], 0
    for start in range(0, padded, chunk):
        sl = slice(start, start + chunk)
        acc = accs[sl] if accs is not None else accumulation
        p0, d0 = generate_camera_rays(scene.camera, xs[sl], ys[sl], acc,
                                      ss[sl], policy.enable_dof, policy)
        rad, cnt = trace_rays(scene, policy, acc, ss[sl], p0, d0,
                              alive0=lane_ok[sl])
        rads.append(rad)
        count = add32(cnt, count)
    flat = Vec3(*(torch.cat([r[k] for r in rads])[:nrays] for k in range(3)))
    if policy.clamp_radiance:
        flat = Vec3(*(torch.clamp_max(c, policy.max_radiance) for c in flat))
    if k_passes > 1:
        flat = Vec3(*(c.reshape(k_passes, npix) for c in flat))
    if order is not None:  # back to raster pixel order
        flat = Vec3(*(c[..., order[1]] for c in flat))
    return flat, count
