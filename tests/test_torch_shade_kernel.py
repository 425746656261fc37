"""The lambertian hit shading of a bounce in two launches (``csrc/shade.cu``
through ``ops/kernels/shade.py``) against the plain path
(``render/renderer.py::bounce_step``'s eager code, held to the JAX package
in the other ``test_torch_*`` files).

On the CPU: the wrappers refuse what the kernels do not take, the dispatch's
test of eligibility (``renderer.shade_kernel_path``) picks the kernels for
the lambertian closure with the uniform pick or at most one light, no
triangle light, a 1x1 sky and an int bounce on the card and the plain path
for everything else, and a CPU render takes the plain path. On the card
(marked ``cuda``): ``shade_frame`` bit for bit ``_closest_hit_frame`` and
``_gather_material`` on lanes that are dead (in groups of four and across
the ragged tail), miss, hit spheres and triangles, face away and sit on the
degenerate tangent frame; ``bounce_step`` with ``shade_frame`` and
``shade_tail`` bit for bit the plain path's on the same lanes with the
intersection and the shadow query answered alike (every ``PathState``
field, the ray count wrapping past 2^32, and ``rays_traced``) at bounce 0,
a middle bounce and the last, with and without ambient, under both
``sky_bug_compat`` branches, without roulette, without MIS, with no light,
with a 1x1 sky texel other than white, on Russian-roulette kills and
survivors, emitter hits with and without ``prev_delta``; renders of the
four benchmark cells' scenes bit-equal with the kernels and with the
dispatch patched to the plain path, one launch of each kernel a bounce and
no lane shaded eagerly; the pool on the plain path; wrong operands raise.
This file imports no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_shade_kernel.py``
runs it on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpu_raytracing_experiments_tpu_torch.core.vec import Quat, Vec3
from cpu_raytracing_experiments_tpu_torch.models import presets
from cpu_raytracing_experiments_tpu_torch.ops import intersect
from cpu_raytracing_experiments_tpu_torch.ops.kernels import shade as kernel
from cpu_raytracing_experiments_tpu_torch.render import renderer
from cpu_raytracing_experiments_tpu_torch.render import wavefront_pool
from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
from cpu_raytracing_experiments_tpu_torch.scene import accel, builders
from cpu_raytracing_experiments_tpu_torch.scene.scene import Sky
from cpu_raytracing_experiments_tpu_torch.utils import profiling
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

torch.set_num_threads(1)

LANES = (1 << 18) + 7
ACCUMULATION = 4_000_000_123  # past 2^31, as the harness's seeds put it


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the shading kernels run there only")


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _vec(n, device, value=1.0):
    return Vec3(*(torch.full((n,), value, device=device) for _ in range(3)))


def _frame_columns(n, device="cpu"):
    """shade_frame's lane operands on `n` lanes."""
    return dict(alive=torch.ones(n, dtype=torch.bool, device=device),
                prim_id=torch.zeros(n, dtype=torch.int32, device=device),
                is_tri=torch.zeros(n, dtype=torch.bool, device=device),
                tfar=torch.ones(n, device=device), p=_vec(n, device),
                d=_vec(n, device))


def _tail_columns(n, device="cpu"):
    """shade_tail's lane operands on `n` lanes (all but the scene)."""
    f = torch.ones(n, device=device)
    b = torch.zeros(n, dtype=torch.bool, device=device)
    return dict(alive=b, hit=b.clone(),
                prim_id=torch.zeros(n, dtype=torch.int32, device=device),
                is_tri=b.clone(), tfar=f.clone(),
                mat_id=torch.zeros(n, dtype=torch.int32, device=device),
                t_quat=Quat(f, f, None, f), p_offset=_vec(n, device),
                p=_vec(n, device), d=_vec(n, device),
                throughput=_vec(n, device), radiance=_vec(n, device),
                prev_pdf=f.clone(), prev_delta=b.clone(), valid=b.clone(),
                ray_count=torch.zeros((), dtype=torch.int64, device=device),
                draws=torch.zeros(3, n, device=device))


TAIL_FLAGS = dict(use_mis=True, inv_l=1.0 / 3, roulette=True,
                  sky_compat=False, last=False)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case, reason", [
    ("cpu columns", "on cpu, not on a CUDA card"),
    ("float64 column", "float64"), ("int64 prim", "int64"),
    ("strided column", "not contiguous"), ("2-d column", "1-D"),
    ("short column", "lanes"), ("no tensor", "not a tensor")])
def test_frame_wrapper_refuses(case, reason):
    """shade_frame raises ValueError on columns it does not take, naming
    why, before it touches a card or the scene."""
    n = 64
    kw = _frame_columns(n)
    if case == "float64 column":
        kw["tfar"] = kw["tfar"].double()
    elif case == "int64 prim":
        kw["prim_id"] = kw["prim_id"].long()
    elif case == "strided column":
        kw["p"] = Vec3(torch.ones(2 * n)[::2], *kw["p"][1:])
    elif case == "2-d column":
        kw["alive"] = kw["alive"].view(8, 8)
    elif case == "short column":
        kw["d"] = Vec3(*kw["d"][:2], torch.ones(n - 1))
    elif case == "no tensor":
        kw["is_tri"] = False
    with pytest.raises(ValueError, match=reason):
        kernel.shade_frame(scene=None, **kw)


@pytest.mark.parametrize("case, reason", [
    ("cpu columns", "on cpu, not on a CUDA card"),
    ("int32 alive", "int32"), ("strided radiance", "not contiguous"),
    ("short prev_pdf", "lanes"), ("float64 mat", "float64"),
    ("no valid tensor", "not a tensor")])
def test_tail_wrapper_refuses(case, reason):
    """shade_tail raises ValueError on columns it does not take."""
    n = 64
    kw = _tail_columns(n)
    if case == "int32 alive":
        kw["alive"] = kw["alive"].int()
    elif case == "strided radiance":
        kw["radiance"] = Vec3(torch.zeros(2 * n)[1::2], *kw["radiance"][1:])
    elif case == "short prev_pdf":
        kw["prev_pdf"] = kw["prev_pdf"][1:]
    elif case == "float64 mat":
        kw["mat_id"] = kw["mat_id"].double()
    elif case == "no valid tensor":
        kw["valid"] = 1
    with pytest.raises(ValueError, match=reason):
        kernel.shade_tail(scene=None, **kw, **TAIL_FLAGS)


@pytest.mark.parametrize("case, reason", [
    ("cpu scene", "on cpu, not on a CUDA card"),
    ("float64 radius", "float64")])
def test_scene_columns_refuse(case, reason):
    """scene_columns raises ValueError on a scene the kernels do not
    read."""
    scene = builders.default_scene(16, 16)
    sp = scene.spheres
    if case == "float64 radius":
        sp = dataclasses.replace(sp, radius_sq=sp.radius_sq.double())
    with pytest.raises(ValueError, match=reason):
        kernel.scene_columns(sp, scene.triangles, scene.materials, scene.sky)


def _one_light(scene):
    return dataclasses.replace(scene, lights=scene.lights[:1])


def _hdri(scene):
    img = np.full((4, 8, 3), 0.5, np.float32)
    return dataclasses.replace(scene, sky=Sky.from_image(img))


def _texel(scene):
    img = np.array([[[0.5, 2.0, 1.5]]], np.float32)
    return dataclasses.replace(scene, sky=Sky.from_image(
        img, ambient=(0.3, 0.2, 0.1)))


ELIGIBLE = {
    # (scene, policy, bounce) -> whether the kernels shade it on the card
    "reference_fixed": ("hero", presets.REFERENCE_FIXED, 0, True),
    "reference_compat": ("hero", presets.REFERENCE_COMPAT, 1, True),
    "preview": ("hero", presets.PREVIEW, 2, True),
    "large_scene": ("hero", presets.LARGE_SCENE, 0, True),
    "throughput on a mesh": ("mesh", presets.THROUGHPUT, 3, True),
    "mesh, uniform": ("mesh", RendererPolicy(), 0, True),
    "no roulette, no mis": ("hero", RendererPolicy(
        russian_roulette=False, mis=False), 1, True),
    "a 1x1 texel sky": ("texel", RendererPolicy(), 0, True),
    "no light": ("furnace", RendererPolicy(), 0, True),
    "ggx": ("hero", RendererPolicy(brdf="ggx"), 0, False),
    "principled": ("hero", RendererPolicy(brdf="principled"), 0, False),
    "production": ("hero", presets.PRODUCTION, 0, False),
    **{f"{mode}, 3 lights": ("hero", RendererPolicy(light_sampling=mode), 0,
                             mode == "uniform")
       for mode in ("uniform", "power", "alias", "ris", "restir")},
    **{f"{mode}, 1 light": ("one light", RendererPolicy(
        light_sampling=mode), 0, True)
       for mode in ("uniform", "power", "alias", "ris", "restir")},
    "triangle lights": ("cornell", RendererPolicy(), 0, False),
    "hdri sky": ("hdri", RendererPolicy(), 0, False),
    "tensor bounce": ("hero", RendererPolicy(), "tensor", False),
}


def _eligibility_scene(kind):
    return {"hero": lambda: builders.default_scene(16, 16),
            "one light": lambda: _one_light(builders.default_scene(16, 16)),
            "mesh": lambda: builders.mesh_scene(16, 16, uv_res=8),
            "cornell": lambda: builders.cornell_box_scene(16, 16),
            "furnace": lambda: builders.white_furnace_scene(16, 16),
            "hdri": lambda: _hdri(builders.default_scene(16, 16)),
            "texel": lambda: _texel(builders.default_scene(16, 16))}[kind]()


@pytest.mark.parametrize("name", sorted(ELIGIBLE))
def test_dispatch_eligibility(name):
    """shade_kernel_path on a CUDA device: the kernels for the lambertian
    closure with the uniform pick (or at most one light), sphere lights
    only, a 1x1 sky and one int bounce; the plain path for GGX, principled,
    'power' / 'alias' / RIS / ReSTIR over three lights, triangle lights, an
    HDRI sky and the pool's per-lane bounce; on the CPU always the plain
    path."""
    kind, policy, bounce, want = ELIGIBLE[name]
    scene = _eligibility_scene(kind)
    zero = torch.zeros(4)
    state = renderer.initial_state(Vec3(zero, zero, zero),
                                   Vec3(zero, zero, zero))
    if bounce == "tensor":
        bounce = torch.zeros(4, dtype=torch.int32)
    state = state._replace(bounce=bounce)
    assert renderer.shade_kernel_path(scene, policy, state,
                                      torch.device("cuda")) is want
    assert renderer.shade_kernel_path(scene, policy, state, "cpu") is False


@pytest.mark.parametrize("kind, policy, want", [
    ("hero", RendererPolicy(), False),
    ("one light", RendererPolicy(light_sampling="power"), False),
    ("hero", RendererPolicy(mis=False), True),
    ("furnace", RendererPolicy(), True)])
def test_kernel_path_takes_nee_from_the_kernels(monkeypatch, kind, policy,
                                                want):
    """Where nee_kernel_path does not hold, the shading kernels take a
    bounce only if its NEE adds nothing (mis=False, or no light): every
    NEE on the kernel path runs the NEE kernels, and a bounce whose NEE is
    the plain path's is shaded on the plain path throughout."""
    scene = _eligibility_scene(kind)
    zero = torch.zeros(4)
    state = renderer.initial_state(Vec3(zero, zero, zero),
                                   Vec3(zero, zero, zero))
    monkeypatch.setattr(renderer, "nee_kernel_path", lambda *a: False)
    assert renderer.shade_kernel_path(scene, policy, state,
                                      torch.device("cuda")) is want


def test_cpu_render_takes_the_plain_path(monkeypatch):
    """On the CPU the renderer shades every bounce on the plain path: the
    kernels never run and no span counts shade_kernel_lanes."""
    scene = builders.default_scene(32, 24)
    policy = RendererPolicy(max_bounces=3)
    calls = []
    real = renderer.shade_kernel_path

    def path(*args):
        calls.append(real(*args))
        return calls[-1]

    def refuse(*args, **kwargs):
        raise AssertionError("the shading kernels on the CPU")

    monkeypatch.setattr(renderer, "shade_kernel_path", path)
    monkeypatch.setattr(renderer, "_bounce_kernels", refuse)
    before = kernel.FRAME.launches, kernel.TAIL.launches
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        Renderer(scene, policy, 32, 24, device="cpu").accumulate(1)
    counts = {k: sum(x["counts"].get(k, 0) for x in profiling.spans())
              for k in ("shade_kernel_lanes", "shade_eager_lanes")}
    assert calls == [False] * 3
    assert counts == {"shade_kernel_lanes": 0, "shade_eager_lanes": 0}
    assert (kernel.FRAME.launches, kernel.TAIL.launches) == before


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _mesh_scene():
    """The small mesh with its first triangle facing +z and its second
    facing -z: two lanes' ways onto the degenerate tangent frame."""
    scene = builders.mesh_scene(64, 64, uv_res=8)
    n = scene.triangles.normal
    for k, z in ((0, 1.0), (1, -1.0)):
        n.x[k], n.y[k], n.z[k] = 0.0, 0.0, z
    return scene


SCENES = {
    "hero": lambda: builders.default_scene(64, 64),
    "hero, ambient": lambda: dataclasses.replace(
        builders.default_scene(64, 64), sky=Sky.constant((0.2, 0.3, 0.4))),
    "hero, texel sky": lambda: _texel(builders.default_scene(64, 64)),
    "hero, one light": lambda: _one_light(builders.default_scene(64, 64)),
    "furnace": lambda: builders.white_furnace_scene(64, 64),
    "mesh": _mesh_scene,
}


def _lanes(scene, n, seed):
    """A bounce's inputs on `n` lanes of the card that take every branch of
    both kernels: about a tenth dead and every seventh group of four lanes
    dead, a tenth missing, hits on every sphere (the lights among them) and
    on triangles, the first two triangles seen from above and below, a
    tenth at a sphere's lowest point with tfar 0 (the degenerate frame),
    random directions (backfaces), throughput from 0 to 1.5 (roulette kills
    and survivors), a fifth after a delta bounce. Returns (the state's
    columns, the intersection's answer, the shadow query's)."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    kind = torch.randint(10, (n,), generator=g)
    lane = torch.arange(n)
    alive = (kind != 0) & ((lane // 4) % 7 != 3)
    n_sph = scene.spheres.count
    tris = scene.triangles.count if scene.triangles is not None else 0
    prim = torch.randint(n_sph, (n,), generator=g, dtype=torch.int32)
    is_tri = torch.zeros(n, dtype=torch.bool)
    if tris:
        is_tri = kind >= 6
        tri_prim = torch.randint(tris, (n,), generator=g, dtype=torch.int32)
        tri_prim = torch.where(kind == 9, lane.to(torch.int32) % 2, tri_prim)
        prim = torch.where(is_tri, tri_prim, prim)
    prim = torch.where(kind == 1, -1, prim)
    p = (u(n, 3) - 0.5) * 6.0
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    tfar = 0.01 + 5.0 * u(n)
    if not tris:
        # the lowest point of the sphere, seen from below: n = (0, 0, -1)
        low = kind == 9
        c = torch.stack([a.cpu() for a in scene.spheres.center], 1)[
            prim.clamp_min(0).long()]
        r = torch.sqrt(scene.spheres.radius_sq.cpu()[prim.clamp_min(0).long()])
        c[:, 2] -= r
        p = torch.where(low[:, None], c, p)
        d[:, 2] = torch.where(low, d[:, 2].abs() + 0.1, d[:, 2])
        tfar = torch.where(low, 0.0, tfar)
    thr = u(n, 3) * 1.5 * (kind != 5)[:, None]
    to = lambda x: x.contiguous().to("cuda")  # noqa: E731
    vec = lambda a: Vec3(*(to(a[:, k]) for k in range(3)))  # noqa: E731
    state = dict(alive=to(alive), p=vec(p), d=vec(d), throughput=vec(thr),
                 radiance=vec(u(n, 3)), prev_pdf=to(2.0 * u(n)),
                 prev_delta=to(u(n) < 0.2))
    answer = (to(tfar), to(prim), to(is_tri))
    return state, answer, to(u(n) < 0.3)


def _cut(x, start, n):
    if isinstance(x, (tuple, list)):
        return type(x)(*(_cut(c, start, n) for c in x)) if isinstance(
            x, Vec3) else type(x)(_cut(c, start, n) for c in x)
    if isinstance(x, dict):
        return {k: _cut(v, start, n) for k, v in x.items()}
    return x[start:start + n]


def _state(cols, bounce, ray_count):
    return renderer.PathState(
        bounce=bounce, ray_count=torch.tensor(ray_count, device="cuda"),
        **cols)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hero", "mesh"])
def test_frame_equals_plain(kind):
    """shade_frame against _closest_hit_frame and _gather_material on
    2^18 + 7 lanes from an aligned start (16-byte groups, a ragged tail)
    and from lane 1 (one lane a thread): hit everywhere, and at hit lanes
    p_offset, the quat's x, y, w, the albedo and the material id bit for
    bit; the lanes reach backfaces and the degenerate frame."""
    _card()
    scene = SCENES[kind]().to("cuda")
    cols, answer, _ = _lanes(scene, LANES + 1, 7)
    scene_cols = kernel.scene_columns(scene.spheres, scene.triangles,
                                      scene.materials, scene.sky)
    policy = RendererPolicy()
    for start in (0, 1):
        c = _cut(cols, start, LANES)
        tfar, prim, is_tri = _cut(answer, start, LANES)
        state = _state(c, 2, 0)
        before = kernel.FRAME.launches
        hit, p_off, quat, albedo, mat = kernel.shade_frame(
            c["alive"], prim, is_tri, tfar, c["p"], c["d"], scene_cols)
        assert kernel.FRAME.launches == before + 1
        want_hit = c["alive"] & (prim >= 0)
        assert _bits_equal(hit, want_hit)
        (w_off, w_n, w_quat, _, w_mat, backface, _,
         _) = renderer._closest_hit_frame(scene, state, tfar, prim, is_tri)
        w_alb = renderer._gather_material(scene, policy, w_mat)["albedo"]
        for got, want in zip(
                (*p_off, quat.x, quat.y, quat.w, *albedo, mat),
                (*w_off, w_quat.x, w_quat.y, w_quat.w, *w_alb, w_mat)):
            assert _bits_equal(got[hit], want[hit]), start
        degenerate = hit & (w_quat.y == 1.0) & (w_quat.w == 0.0)
        assert int(degenerate.sum()) > 0 and int((hit & backface).sum()) > 0
        assert int((hit & ~backface).sum()) > 0
        if kind == "mesh":
            assert int((hit & is_tri).sum()) > 0
            assert int((hit & ~is_tri).sum()) > 0


TAIL_CASES = {
    # (scene, policy knobs, bounce)
    "hero, bounce 0": ("hero", {}, 0),
    "hero, bounce 3": ("hero", {}, 3),
    "hero, the last bounce": ("hero", {}, 7),
    "ambient": ("hero, ambient", {}, 2),
    "ambient, sky_bug_compat": ("hero, ambient", {"sky_bug_compat": True},
                                2),
    "texel sky, no roulette": ("hero, texel sky",
                               {"russian_roulette": False}, 1),
    "no mis": ("hero, ambient", {"mis": False}, 2),
    "one light under 'power'": ("hero, one light",
                                {"light_sampling": "power"}, 4),
    "no light": ("furnace", {}, 1),
    "mesh": ("mesh", {}, 2),
}


def _bounce(scene, policy, state, answer, occluded, seeds, monkeypatch,
            kernels):
    """bounce_step with the intersection and the shadow query answered by
    `answer` and `occluded`, on the kernels or the plain path: (the next
    state, rays_traced counted under a profiler session)."""
    monkeypatch.setattr(intersect, "intersect_scene", lambda *a, **k: answer)
    monkeypatch.setattr(intersect, "occluded_scene",
                        lambda *a, **k: occluded)
    if not kernels:
        monkeypatch.setattr(renderer, "shade_kernel_path", lambda *a: False)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("port.bounce"):
            out = renderer.bounce_step(scene, policy, ACCUMULATION, seeds,
                                       state)
    rays = sum(x["counts"].get("rays_traced", 0) for x in profiling.spans())
    monkeypatch.undo()
    return out, rays


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_bounce_equals_plain(monkeypatch, name):
    """bounce_step on the kernels (shade_frame, NEE, shade_tail) against
    bounce_step on the plain path, the intersection and the shadow query
    answered alike, on 2^18 + 7 lanes from an aligned start and from lane
    1: every PathState field bit for bit, the ray count (wrapping past
    2^32) and rays_traced equal; the lanes reach roulette kills and
    survivors, emitter hits and sky lanes where the case has them."""
    _card()
    kind, knobs, bounce = TAIL_CASES[name]
    scene = SCENES[kind]().to("cuda")
    policy = RendererPolicy(max_bounces=8, **knobs)
    cols, answer, occluded = _lanes(scene, LANES + 1, 11)
    seeds = torch.randint(0, 2 ** 32, (LANES + 1,), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(5)).cuda()
    for start in (0, 1):
        state = _state(_cut(cols, start, LANES), bounce, 2 ** 32 - 1000)
        ans, occ = _cut(answer, start, LANES), occluded[start:start + LANES]
        s = seeds[start:start + LANES]
        assert renderer.shade_kernel_path(scene, policy, state, "cuda")
        before = kernel.FRAME.launches, kernel.TAIL.launches
        got, got_rays = _bounce(scene, policy, state, ans, occ, s,
                                monkeypatch, True)
        assert (kernel.FRAME.launches, kernel.TAIL.launches) == (
            before[0] + 1, before[1] + 1)
        want, want_rays = _bounce(scene, policy, state, ans, occ, s,
                                  monkeypatch, False)
        assert (kernel.FRAME.launches, kernel.TAIL.launches) == (
            before[0] + 1, before[1] + 1)
        assert got.bounce == want.bounce == bounce + 1
        for field in ("p", "d", "throughput", "radiance"):
            for a, b in zip(getattr(got, field), getattr(want, field)):
                assert _bits_equal(a, b), (field, start)
        for field in ("prev_pdf", "prev_delta", "alive", "ray_count"):
            assert _bits_equal(getattr(got, field),
                               getattr(want, field)), (field, start)
        assert got_rays == want_rays > 0
        assert int(want.ray_count) < 2 ** 32 - 1000
        hit = state.alive & (ans[1] >= 0)
        if scene.num_lights:  # emitter hits with and without prev_delta
            emit = hit & ~ans[2] & torch.isin(
                ans[1], scene.lights.to(ans[1].dtype))
            assert int((emit & state.prev_delta).sum()) > 0
            assert int((emit & ~state.prev_delta).sum()) > 0
        if bounce + 1 < policy.max_bounces:
            assert int((hit & want.alive).sum()) > 0
        if policy.russian_roulette and bounce + 1 < policy.max_bounces:
            assert int((hit & ~want.alive).sum()) > 0


RENDERS = {
    # the four benchmark cells' scenes and policies at 256x128
    "hero": ("hero", {"max_bounces": 8, "rays_per_chunk": 1 << 17}, 4),
    "mesh100k final": ("mesh100k", {"max_bounces": 8, "accel": "pallas"},
                       1),
    "mesh100k preview": ("mesh100k", {
        "max_bounces": 4, "samples_per_pixel": 4, "stratify_camera": True,
        "accel": "pallas"}, 1),
    "mesh1p3m": ("mesh1p3m", {"max_bounces": 8, "accel": "pallas"}, 2),
}
_RENDER_SCENES = {}


def _render_scene(kind, w, h):
    if kind not in _RENDER_SCENES:
        if kind == "hero":
            scene = builders.default_scene(w, h)
        else:
            scene = accel.with_pallas_clusters(builders.mesh_scene(
                w, h, uv_res=224 if kind == "mesh100k" else 810))
        _RENDER_SCENES[kind] = scene.to("cuda")
    return _RENDER_SCENES[kind]


def _render(kind, policy, passes):
    w, h = 256, 128
    r = Renderer(_render_scene(kind, w, h), RendererPolicy(**policy), w, h,
                 device="cuda")
    r.accumulate(passes)
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_equals_plain_path(monkeypatch, name):
    """A 256x128 render of each benchmark cell's scene: buckets and rays
    bit-equal with the kernels and with the dispatch patched to the plain
    path; with the kernels each bounce launches shade_frame and shade_tail
    once and shades no lane eagerly."""
    _card()
    kind, policy, passes = RENDERS[name]
    r = _render(kind, policy, passes)
    profiling.clear()
    before = kernel.FRAME.launches
    with profile(activities=[ProfilerActivity.CPU]):
        r.accumulate(passes)
    recs = profiling.spans()
    launched = kernel.FRAME.launches - before
    counts = {k: sum(x["counts"].get(k, 0) for x in recs)
              for k in ("launches.shade_frame", "launches.shade_tail",
                        "shade_kernel_lanes", "shade_eager_lanes")}
    bounces = [x for x in recs if x["name"] == "port.bounce"]
    assert launched == counts["launches.shade_frame"] == len(bounces) > 0
    assert counts["launches.shade_tail"] == len(bounces)
    assert counts["shade_eager_lanes"] == 0
    assert counts["shade_kernel_lanes"] == sum(x["attrs"]["lanes"]
                                               for x in bounces)
    got = r.state.buckets.cpu()
    rays = int(r.state.rays_traced)
    monkeypatch.setattr(renderer, "shade_kernel_path", lambda *a: False)
    plain = _render(kind, policy, passes)
    plain.accumulate(passes)
    assert kernel.FRAME.launches == before + launched
    assert _bits_equal(got, plain.state.buckets)
    assert rays == int(plain.state.rays_traced)


@pytest.mark.cuda
def test_pool_takes_the_plain_path():
    """render_pass_pooled (each lane its own bounce) shades on the plain
    path: no shading kernel launches, every bounce's lanes counted as
    shade_eager_lanes."""
    _card()
    scene = builders.default_scene(64, 64).to("cuda")
    policy = RendererPolicy(max_bounces=8, rays_per_chunk=1024)
    before = kernel.FRAME.launches, kernel.TAIL.launches
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("port.update"):
            wavefront_pool.render_pass_pooled(scene, policy, 3, 64, 64)
    eager = sum(x["counts"].get("shade_eager_lanes", 0)
                for x in profiling.spans())
    assert (kernel.FRAME.launches, kernel.TAIL.launches) == before
    assert eager > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cpu column", "int64 prim", "short draws",
                                  "cpu ray_count", "int32 ray_count",
                                  "float64 scene column"])
def test_wrong_operands_raise_on_the_card(case):
    """Columns of another device or type, draws, a ray count or a scene the
    kernels do not take: ValueError, nothing launched."""
    _card()
    n = 64
    scene = builders.default_scene(16, 16).to("cuda")
    sp = scene.spheres
    if case == "float64 scene column":
        sp = dataclasses.replace(sp, radius_sq=sp.radius_sq.double())
        with pytest.raises(ValueError, match="float64"):
            kernel.scene_columns(sp, None, scene.materials, scene.sky)
        return
    cols = kernel.scene_columns(sp, None, scene.materials, scene.sky)
    frame = _frame_columns(n, "cuda")
    tail = _tail_columns(n, "cuda")
    if case == "cpu column":
        frame["tfar"] = frame["tfar"].cpu()
        tail["tfar"] = tail["tfar"].cpu()
    elif case == "int64 prim":
        frame["prim_id"] = frame["prim_id"].long()
        tail["prim_id"] = tail["prim_id"].long()
    elif case == "short draws":
        tail["draws"] = tail["draws"][:2]
    elif case == "cpu ray_count":
        tail["ray_count"] = tail["ray_count"].cpu()
    else:
        tail["ray_count"] = tail["ray_count"].int()
    before = kernel.FRAME.launches, kernel.TAIL.launches
    if case in ("cpu column", "int64 prim"):
        with pytest.raises(ValueError):
            kernel.shade_frame(scene=cols, **frame)
    with pytest.raises(ValueError):
        kernel.shade_tail(scene=cols, **tail, **TAIL_FLAGS)
    assert (kernel.FRAME.launches, kernel.TAIL.launches) == before
