"""Next-event estimation toward sphere lights in two launches
(``csrc/nee.cu`` through ``ops/kernels/nee.py``) against the plain path
(``render/renderer.py::_next_event_estimation``, held to the JAX package
in the other ``test_torch_*`` files).

On the CPU: the wrappers refuse what the kernels do not take, the renderer
shades NEE on the plain path there, the dispatch's test of eligibility picks
the kernels for the lambertian presets with sphere lights and the plain path
for GGX, principled, 'power' over three lights, RIS, ReSTIR and triangle
lights, and the packed light table equals the plain path's rows. On the card
(marked ``cuda``): ``nee_sphere`` and ``nee_combine`` bit for bit the plain
path's l_dir, shadow tfar, valid and radiance on 2^20 + 7 lanes from an
aligned and a misaligned start, with 1, 3 and 4,000 lights (a table staged
in shared memory and one read through the read-only cache), on lanes that
are dead, that hit a light, that sit inside a light, whose cone lies below
the hemisphere, on the small-angle branch, whose sample lies below the
hemisphere and whose radiance is zero; renders (the hero, the small mesh
under 'pallas', the pool) bit-equal with the kernels and with the dispatch
patched to the plain path, one ``nee_sphere`` launch a bounce and no lane
shaded eagerly; wrong operands raise. This file imports no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_nee_kernel.py``
runs it on the card.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpu_raytracing_experiments_tpu_torch.core import sampling
from cpu_raytracing_experiments_tpu_torch.core.vec import Quat, Vec3
from cpu_raytracing_experiments_tpu_torch.models import presets
from cpu_raytracing_experiments_tpu_torch.ops import gather, intersect
from cpu_raytracing_experiments_tpu_torch.ops.kernels import nee as kernel
from cpu_raytracing_experiments_tpu_torch.render import renderer
from cpu_raytracing_experiments_tpu_torch.render import wavefront_pool
from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
from cpu_raytracing_experiments_tpu_torch.scene import accel, builders
from cpu_raytracing_experiments_tpu_torch.utils import profiling
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

torch.set_num_threads(1)

LANES = (1 << 20) + 7


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the NEE kernels run there only")


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _columns(n, device="cpu"):
    """nee_sphere's operands on `n` lanes of float32 ones (bool and int32
    where the kernel reads those)."""
    f = [torch.ones(n, device=device) for _ in range(12)]
    return dict(hit=torch.ones(n, dtype=torch.bool, device=device),
                prim_id=torch.zeros(n, dtype=torch.int32, device=device),
                is_tri=torch.zeros(n, dtype=torch.bool, device=device),
                p_offset=Vec3(*f[:3]), t_quat=Quat(f[3], f[4], f[5], f[5]),
                albedo=Vec3(*f[6:9]), throughput=Vec3(*f[9:]),
                draws=torch.zeros(3, n, device=device),
                lights=torch.zeros(3, kernel.ROW, device=device))


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case, reason", [
    ("cpu columns", "on cpu, not on a CUDA card"),
    ("float64 column", "float64"),
    ("int64 prim", "int64"), ("strided column", "not contiguous"),
    ("2-d column", "1-D"), ("short column", "lanes"),
    ("no tensor", "not a tensor")])
def test_sphere_wrapper_refuses(case, reason):
    """nee_sphere raises ValueError on columns it does not take, naming
    why, before it touches a card."""
    n = 64
    kw = _columns(n)
    if case == "float64 column":
        kw["albedo"] = Vec3(kw["albedo"].x.double(), *kw["albedo"][1:])
    elif case == "int64 prim":
        kw["prim_id"] = kw["prim_id"].long()
    elif case == "strided column":
        kw["p_offset"] = Vec3(torch.ones(2 * n)[::2], *kw["p_offset"][1:])
    elif case == "2-d column":
        kw["hit"] = kw["hit"].view(8, 8)
    elif case == "short column":
        kw["throughput"] = Vec3(*kw["throughput"][:2], torch.ones(n - 1))
    elif case == "no tensor":
        kw["is_tri"] = False
    with pytest.raises(ValueError, match=reason):
        kernel.nee_sphere(**kw)


@pytest.mark.parametrize("case, reason", [
    ("cpu columns", "on cpu, not on a CUDA card"), ("int32 valid", "int32"),
    ("strided radiance", "not contiguous"), ("short occluded", "lanes")])
def test_combine_wrapper_refuses(case, reason):
    """nee_combine raises ValueError on columns it does not take."""
    n = 64
    rad = Vec3(*(torch.zeros(n) for _ in range(3)))
    sh = Vec3(*(torch.ones(n) for _ in range(3)))
    valid = torch.ones(n, dtype=torch.bool)
    occ = torch.zeros(n, dtype=torch.bool)
    if case == "int32 valid":
        valid = valid.int()
    elif case == "strided radiance":
        rad = Vec3(torch.zeros(2 * n)[1::2], *rad[1:])
    elif case == "short occluded":
        occ = occ[1:]
    with pytest.raises(ValueError, match=reason):
        kernel.nee_combine(rad, valid, occ, sh)


def test_cpu_render_takes_the_plain_path(monkeypatch):
    """On the CPU the renderer shades NEE with _next_event_estimation and
    never reaches the kernels."""
    scene = builders.default_scene(32, 24)
    policy = RendererPolicy(max_bounces=3)
    assert not renderer.nee_kernel_path(scene, policy, torch.device("cpu"))
    calls = []
    real = renderer._next_event_estimation

    def plain(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the NEE kernels on the CPU")

    monkeypatch.setattr(renderer, "_next_event_estimation", plain)
    monkeypatch.setattr(renderer, "_nee_sphere_kernels", refuse)
    before = kernel.SPHERE.launches, kernel.COMBINE.launches
    Renderer(scene, policy, 32, 24, device="cpu").accumulate(1)
    assert len(calls) == 3
    assert (kernel.SPHERE.launches, kernel.COMBINE.launches) == before


def _tri_light_scene():
    return builders.cornell_box_scene(16, 16)


ELIGIBLE = {
    # (scene, policy) -> whether the kernels shade NEE on the card
    "reference_fixed": ("hero", presets.REFERENCE_FIXED, True),
    "preview": ("hero", presets.PREVIEW, True),
    "reference_compat": ("hero", presets.REFERENCE_COMPAT, True),
    "large_scene": ("hero", presets.LARGE_SCENE, True),
    "throughput": ("hero", presets.THROUGHPUT, True),
    "mesh preview": ("mesh", presets.PREVIEW, True),
    "power, one light": ("one light", RendererPolicy(light_sampling="power"),
                         True),
    "ggx": ("hero", RendererPolicy(brdf="ggx"), False),
    "principled": ("hero", RendererPolicy(brdf="principled"), False),
    "production": ("hero", presets.PRODUCTION, False),
    "power, 3 lights": ("hero", RendererPolicy(light_sampling="power"),
                        False),
    "alias, 3 lights": ("hero", RendererPolicy(light_sampling="alias"),
                        False),
    "ris": ("hero", RendererPolicy(light_sampling="ris"), False),
    "restir": ("hero", RendererPolicy(light_sampling="restir"), False),
    "triangle light": ("cornell", RendererPolicy(), False),
    "no mis": ("hero", RendererPolicy(mis=False), False),
}


@pytest.mark.parametrize("name", sorted(ELIGIBLE))
def test_dispatch_eligibility(name):
    """nee_kernel_path on a CUDA device: the kernels for the lambertian
    presets with MIS over sphere lights picked uniformly (or one light),
    the plain path for every other closure, selection and light kind; on
    the CPU always the plain path."""
    kind, policy, want = ELIGIBLE[name]
    scene = {"hero": lambda: builders.default_scene(16, 16),
             "one light": lambda: dataclasses.replace(
                 builders.default_scene(16, 16),
                 lights=builders.default_scene(16, 16).lights[:1]),
             "mesh": lambda: builders.mesh_scene(16, 16, uv_res=8),
             "cornell": _tri_light_scene}[kind]()
    assert renderer.nee_kernel_path(scene, policy, torch.device("cuda")) \
        is want
    assert renderer.nee_kernel_path(scene, policy, "cpu") is False


def test_light_table_is_the_plain_rows():
    """_sphere_light_table equals the [L, 8] rows _sphere_light_sample
    gathers, is packed once for the same arrays, and anew after an
    in-place edit of one of them."""
    scene = builders.default_scene(16, 16)
    sl = scene.lights.to(torch.int64)
    sp, em = scene.spheres, scene.materials.emission
    mid = sp.material_id[sl].to(torch.int64)
    want = gather.pack_table(sl, sp.center.x[sl], sp.center.y[sl],
                             sp.center.z[sl], sp.radius_sq[sl], em.x[mid],
                             em.y[mid], em.z[mid])
    table = renderer._sphere_light_table(scene)
    assert table.shape == (3, kernel.ROW) and table.is_contiguous()
    assert _bits_equal(table, want)
    assert renderer._sphere_light_table(scene) is table
    sp.radius_sq.mul_(4.0)
    again = renderer._sphere_light_table(scene)
    assert again is not table
    assert _bits_equal(again[:, 4], 4.0 * want[:, 4])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _scene(lights: int):
    """The hero with its first light (1), its three (3), or a 4,000-sphere
    field whose every sphere is a light (4000: above what a block stages),
    on the card."""
    if lights == 4000:
        scene = builders.random_spheres_scene(64, 64, num_spheres=4000,
                                              emissive_fraction=0.5)
        scene = dataclasses.replace(
            scene, lights=torch.arange(4000, dtype=torch.int32))
    else:
        scene = builders.default_scene(64, 64)
        scene = dataclasses.replace(scene, lights=scene.lights[:lights])
    return scene.to("cuda")


def _lanes(scene, n, seed):
    """A closest-hit state on `n` lanes of the card whose NEE takes every
    branch: a tenth dead, a tenth on a light's own sphere (the self test),
    some triangle hits on a light's prim id, a tenth at a light's center
    (inside it), points 0.05-6 units from the lights (the small-angle
    branch beyond about 1.9 from the hero's lights), random normals (cones
    and samples below the hemisphere), a tenth with zero albedo, throughput
    or both."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    sl = scene.lights.cpu().to(torch.int64)
    c = torch.stack([a.cpu() for a in scene.spheres.center], 1)
    pick = sl[torch.randint(len(sl), (n,), generator=g)]
    r = torch.sqrt(scene.spheres.radius_sq.cpu()[pick])
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    dist = r + 0.05 + 6.0 * u(n) ** 2
    p = c[pick] + d * dist[:, None]
    kind = torch.randint(10, (n,), generator=g)
    p = torch.where((kind == 2)[:, None], c[pick], p)
    n_rand = torch.nn.functional.normalize(torch.randn(n, 3, generator=g),
                                           dim=1)
    # a normal facing the light on about half the lanes
    n_vec = torch.where((u(n) < 0.5)[:, None], -d, n_rand)
    hit = kind != 0
    prim = torch.randint(scene.spheres.count, (n,), generator=g,
                         dtype=torch.int32)
    prim = torch.where(kind == 1, pick.to(torch.int32), prim)
    is_tri = (kind == 3) & (u(n) < 0.5)
    prim = torch.where(is_tri, pick.to(torch.int32), prim)
    albedo = u(n, 3) * (kind != 4)[:, None]
    thr = u(n, 3) * 2.0 * (kind != 5)[:, None]
    thr[:, 0] *= (kind != 6)
    to = lambda x: x.contiguous().to("cuda")  # noqa: E731
    n_card = Vec3(*(to(n_vec[:, k]) for k in range(3)))
    return dict(hit=to(hit), prim_id=to(prim), is_tri=to(is_tri),
                p_offset=Vec3(*(to(p[:, k]) for k in range(3))),
                t_quat=sampling.tangent_space(n_card),
                albedo=Vec3(*(to(albedo[:, k]) for k in range(3))),
                throughput=Vec3(*(to(thr[:, k]) for k in range(3))),
                radiance=Vec3(*(to(u(n)) for _ in range(3))),
                occluded=to(u(n) < 0.3))


def _cut(lanes, start, n):
    def cut(x):
        if isinstance(x, tuple):
            return type(x)(*(cut(c) for c in x))
        return x[start:start + n]
    return {k: cut(v) for k, v in lanes.items()}


def _plain(scene, policy, lanes, accumulation, seeds, bounce, monkeypatch):
    """The plain path on `lanes`: (l_dir, tfar, valid, radiance) with the
    shadow query answered by lanes['occluded']."""
    seen = {}

    def occluded_scene(scene_, p, d, tfar, **kw):
        seen["d"], seen["tfar"] = d, tfar
        return lanes["occluded"]

    monkeypatch.setattr(intersect, "occluded_scene", occluded_scene)
    zero = torch.zeros_like(lanes["radiance"].x)
    state = renderer.PathState(
        bounce=bounce, p=lanes["p_offset"], d=lanes["p_offset"],
        throughput=lanes["throughput"], radiance=lanes["radiance"],
        prev_pdf=zero, prev_delta=lanes["hit"], alive=lanes["hit"],
        ray_count=torch.zeros((), dtype=torch.int64, device="cuda"))
    mat = {"albedo": lanes["albedo"]}
    contribution, valid, _ = renderer._next_event_estimation(
        scene, policy, state, accumulation, seeds, lanes["hit"],
        lanes["prim_id"], lanes["is_tri"], lanes["p_offset"],
        lanes["t_quat"], None, mat)
    monkeypatch.undo()
    return (seen["d"], seen["tfar"], valid,
            lanes["radiance"] + contribution), state


@pytest.mark.cuda
@pytest.mark.parametrize("lights", [1, 3, 4000])
def test_kernels_equal_plain(monkeypatch, lights):
    """nee_sphere + nee_combine against _next_event_estimation and its add
    on 2^20 + 7 lanes that take every branch, from an aligned start
    (16-byte groups, a ragged tail) and from lane 1 (one lane a thread):
    l_dir, tfar, valid and the radiance bit for bit."""
    _card()
    scene = _scene(lights)
    policy = RendererPolicy()
    lanes = _lanes(scene, LANES + 1, lights)
    seeds = torch.randint(0, 2 ** 32, (LANES + 1,), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(9)).cuda()
    from cpu_raytracing_experiments_tpu_torch.core import rng

    for start in (0, 1):
        cut = _cut(lanes, start, LANES)
        s = seeds[start:start + LANES]
        want, state = _plain(scene, policy, cut, 4_000_000_123, s, 3,
                             monkeypatch)
        draws = rng.site_draws(4_000_000_123, s, 6, 3, False)
        before = kernel.SPHERE.launches, kernel.COMBINE.launches
        l_dir, tfar, valid, shadow = kernel.nee_sphere(
            cut["hit"], cut["prim_id"], cut["is_tri"], cut["p_offset"],
            cut["t_quat"], cut["albedo"], cut["throughput"], draws,
            renderer._sphere_light_table(scene))
        radiance = kernel.nee_combine(cut["radiance"], valid,
                                      cut["occluded"], shadow)
        assert (kernel.SPHERE.launches, kernel.COMBINE.launches) == (
            before[0] + 1, before[1] + 1)
        for got, exp in zip((*l_dir, tfar, valid, *radiance),
                            (*want[0], want[1], want[2], *want[3])):
            assert _bits_equal(got, exp), start
        assert 0 < int(valid.sum()) < int(cut["hit"].sum())


@pytest.mark.cuda
def test_lanes_take_every_branch():
    """The lanes of test_kernels_equal_plain reach each of the kernel's
    exits on the hero's lights: self, inside, the cone below, the small
    angle, the sample below, zero radiance, and valid."""
    _card()
    scene = _scene(3)
    lanes = _lanes(scene, 1 << 16, 3)
    table = renderer._sphere_light_table(scene)
    draws = torch.rand(3, 1 << 16, device="cuda")
    l_dir, tfar, valid, _ = kernel.nee_sphere(
        lanes["hit"], lanes["prim_id"], lanes["is_tri"], lanes["p_offset"],
        lanes["t_quat"], lanes["albedo"], lanes["throughput"], draws, table)
    sel = torch.clamp((draws[2] * 3.0).long(), max=2)
    c = Vec3(*(table[sel, k] for k in (1, 2, 3)))
    w = c - lanes["p_offset"]
    d2 = w.x * w.x + w.y * w.y + w.z * w.z
    hit = lanes["hit"]
    self_ = hit & ~lanes["is_tri"] & (table[sel, 0].int() == lanes["prim_id"])
    inside = hit & (d2 <= table[sel, 4])
    ok = (l_dir.x != 0) | (l_dir.y != 0) | (l_dir.z != 0)
    small = ok & (table[sel, 4] / d2 < 0.00068523)
    zero_rad = hit & ok & ~valid & (lanes["albedo"].x == 0)
    for name, m in (("self", self_), ("inside", inside), ("small", small),
                    ("ok", ok), ("valid", valid), ("ok not valid",
                                                   ok & ~valid),
                    ("zero radiance", zero_rad),
                    ("hit not ok", hit & ~ok & ~self_ & ~inside)):
        assert int(m.sum()) > 0, name
    assert int((tfar[~valid] != 0).sum()) == 0


RENDERS = {
    # the hero, 4 passes packed into one wavefront
    "hero": ("hero", {"max_bounces": 8, "rays_per_chunk": 1 << 17}, 4),
    # the preview on the small mesh under 'pallas'
    "preview": ("mesh", {"max_bounces": 4, "samples_per_pixel": 4,
                         "stratify_camera": True, "accel": "pallas"}, 1),
    # one light under 'power' (the uniform pick), scrambled draws
    "one light": ("one light", {"light_sampling": "power",
                                "rng_scramble": True}, 2),
}


def _render(kind, policy, passes):
    w, h = 256, 128
    if kind == "mesh":
        scene = accel.with_pallas_clusters(builders.mesh_scene(w, h,
                                                               uv_res=32))
    else:
        scene = builders.default_scene(w, h)
        if kind == "one light":
            scene = dataclasses.replace(scene, lights=scene.lights[:1])
    r = Renderer(scene, RendererPolicy(**policy), w, h, device="cuda")
    r.accumulate(passes)
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_equals_plain_path(monkeypatch, name):
    """A 256x128 render's buckets bit-equal with the kernels and with the
    dispatch patched to the plain path; with the kernels each bounce
    launches nee_sphere and nee_combine once and shades no lane eagerly."""
    _card()
    kind, policy, passes = RENDERS[name]
    r = _render(kind, policy, passes)
    profiling.clear()
    before = kernel.SPHERE.launches
    with profile(activities=[ProfilerActivity.CPU]):
        r.accumulate(passes)
    recs = profiling.spans()
    launched = kernel.SPHERE.launches - before
    counts = {k: sum(x["counts"].get(k, 0) for x in recs)
              for k in ("launches.nee_sphere", "launches.nee_combine",
                        "nee_kernel_lanes", "nee_eager_lanes")}
    bounces = [x for x in recs if x["name"] == "port.bounce"]
    assert launched == counts["launches.nee_sphere"] == len(bounces) > 0
    assert counts["launches.nee_combine"] == len(bounces)
    assert counts["nee_eager_lanes"] == 0
    assert counts["nee_kernel_lanes"] == sum(x["attrs"]["lanes"]
                                             for x in bounces)
    got = r.state.buckets.cpu()
    monkeypatch.setattr(renderer, "nee_kernel_path", lambda *a: False)
    plain = _render(kind, policy, passes)
    plain.accumulate(passes)
    assert kernel.SPHERE.launches == before + launched
    assert _bits_equal(got, plain.state.buckets)


@pytest.mark.cuda
def test_pool_equals_plain_path(monkeypatch):
    """render_pass_pooled (each lane its own bounce) bit-equal with the
    kernels and with the plain path."""
    _card()
    scene = builders.default_scene(64, 64).to("cuda")
    policy = RendererPolicy(max_bounces=8, rays_per_chunk=1024)
    before = kernel.SPHERE.launches
    got = wavefront_pool.render_pass_pooled(scene, policy, 3, 64, 64)
    assert kernel.SPHERE.launches > before
    monkeypatch.setattr(renderer, "nee_kernel_path", lambda *a: False)
    want = wavefront_pool.render_pass_pooled(scene, policy, 3, 64, 64)
    for a, b in zip(got[0], want[0]):
        assert _bits_equal(a, b)
    assert int(got[1]) == int(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cpu column", "cpu draws", "int64 prim",
                                  "strided column", "short draws",
                                  "lights of 7 columns", "cpu lights"])
def test_wrong_operands_raise_on_the_card(case):
    """Columns of another device, type or layout, draws or a light table
    the kernel does not take: ValueError, nothing launched."""
    _card()
    n = 64
    kw = _columns(n, "cuda")
    if case == "cpu column":
        kw["albedo"] = Vec3(kw["albedo"].x.cpu(), *kw["albedo"][1:])
    elif case == "cpu draws":
        kw["draws"] = kw["draws"].cpu()
    elif case == "int64 prim":
        kw["prim_id"] = kw["prim_id"].long()
    elif case == "strided column":
        kw["p_offset"] = Vec3(torch.ones(2 * n, device="cuda")[::2],
                              *kw["p_offset"][1:])
    elif case == "short draws":
        kw["draws"] = kw["draws"][:2]
    elif case == "lights of 7 columns":
        kw["lights"] = kw["lights"][:, :7].contiguous()
    else:
        kw["lights"] = kw["lights"].cpu()
    before = kernel.SPHERE.launches
    with pytest.raises(ValueError):
        kernel.nee_sphere(**kw)
    assert kernel.SPHERE.launches == before
