"""The counter RNG's site kernel (``csrc/rng.cu`` through
``ops/kernels/rng.py``) against its plain version
(``core/rng.py::site_draws_plain``, held to the JAX package in
``tests/test_torch_rng.py``).

On the CPU: the wrapper refuses what the kernel does not take, and
``core.rng.site_draws`` takes the plain version. On the card (marked
``cuda``): every form of a site (an accumulation of one value or one a
lane, an offset of one value or one int32 a lane, 1-5 draws, scramble,
the final state, the stratified jitter) bit for bit the plain version's on
2^20 + 7 lanes (a ragged tail) from an aligned and a misaligned start;
renders (the pool and ambient occlusion too) bit-equal with the kernel and
with ``rng.site_draws`` patched to the plain version, with every site
launched as the kernel and nothing eager but the pixel seeds outside RIS;
wrong devices and types raise. This file imports no JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_rng_kernel.py``
runs it on the card.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpu_raytracing_experiments_tpu_torch.core import rng
from cpu_raytracing_experiments_tpu_torch.ops.kernels import rng as kernel
from cpu_raytracing_experiments_tpu_torch.render import ao, wavefront_pool
from cpu_raytracing_experiments_tpu_torch.render.api import Renderer
from cpu_raytracing_experiments_tpu_torch.scene import accel, builders
from cpu_raytracing_experiments_tpu_torch.utils import profiling
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

torch.set_num_threads(1)

LANES = (1 << 20) + 7
EDGES = [0, 1, 2, 3, 12345, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFE,
         0xFFFFFFFF, 747796405, 2891336453]


def _u32(seed, n):
    g = np.random.default_rng(seed)
    x = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.int64)
    x[:len(EDGES)] = EDGES
    return torch.from_numpy(x)


def _operands(acc_kind, offset_kind, n=LANES + 1):
    """CPU (seeds, accumulation, offset) of one more lane than LANES, so
    that [1:] is a misaligned start."""
    seeds = _u32(1, n)
    acc = _u32(2, n) if acc_kind == "lane" else 0xFFFFFFFE
    offset = (torch.from_numpy(np.random.default_rng(3).integers(
        0, 2 ** 31, n).astype(np.int32)) if offset_kind == "lane" else 13)
    return seeds, acc, offset


def _cut(x, start):
    """x[start:start + LANES] of a tensor (from lane 1 a start off the
    16-byte groups), an int as it is."""
    if isinstance(x, torch.Tensor):
        return x[start:start + LANES]
    return x


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the RNG site kernel runs there only")


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version():
    """core.rng.site_draws on CPU tensors is site_draws_plain, and launches
    nothing."""
    seeds, acc, offset = _operands("lane", "lane", 64)
    before = kernel.SITE.launches
    got, state = rng.site_draws(acc, seeds, offset, 3, True, want_state=True)
    want, want_state = rng.site_draws_plain(acc, seeds, offset, 3, True,
                                            want_state=True)
    assert _bits_equal(got, want) and _bits_equal(state, want_state)
    assert kernel.SITE.launches == before


@pytest.mark.parametrize("case", ["cpu seeds", "int32 seeds", "2-d seeds",
                                  "no tensor", "6 draws", "jitter of 1"])
def test_wrapper_refuses_without_a_card(case):
    """The kernel's wrapper raises ValueError on operands it does not take,
    before it touches a card."""
    seeds = _u32(4, 16)
    args = {"cpu seeds": (0, seeds, 0, 2),
            "int32 seeds": (0, seeds.to(torch.int32), 0, 2),
            "2-d seeds": (0, seeds.view(4, 4), 0, 2),
            "no tensor": (0, 7, 0, 2),
            "6 draws": (0, seeds, 0, 6),
            "jitter of 1": (0, seeds, 0, 1)}[case]
    with pytest.raises(ValueError):
        kernel.site_draws(*args, False, jitter=case == "jitter of 1")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("scramble", [False, True])
@pytest.mark.parametrize("offset_kind", ["int", "lane"])
@pytest.mark.parametrize("acc_kind", ["scalar", "lane"])
def test_kernel_equals_plain(acc_kind, offset_kind, scramble):
    """Every row and the final state, 1-5 draws, on 2^20 + 7 lanes from an
    aligned start (16-byte groups and a ragged tail) and from lane 1 (one
    lane a thread): bit for bit the plain version's."""
    _card()
    seeds, acc, offset = _operands(acc_kind, offset_kind)
    card = [x.cuda() if isinstance(x, torch.Tensor) else x
            for x in (seeds, acc, offset)]
    for start in (0, 1):
        plain = [_cut(x, start) for x in (seeds, acc, offset)]
        on_card = [_cut(x, start) for x in card]
        for n in range(1, 6):
            want, want_state = rng.site_draws_plain(
                plain[1], plain[0], plain[2], n, scramble, want_state=True)
            before = kernel.SITE.launches
            rows = rng.site_draws(on_card[1], on_card[0], on_card[2], n,
                                  scramble)
            rows2, state = rng.site_draws(on_card[1], on_card[0], on_card[2],
                                          n, scramble, want_state=True)
            assert kernel.SITE.launches == before + 2
            assert rows.shape == (n, LANES) and rows.is_cuda
            assert _bits_equal(rows, want), (start, n)
            assert _bits_equal(rows2, want), (start, n)
            assert _bits_equal(state, want_state), (start, n)


@pytest.mark.cuda
@pytest.mark.parametrize("scramble", [False, True])
@pytest.mark.parametrize("acc_kind", ["scalar", "lane"])
def test_kernel_jitter_equals_plain(acc_kind, scramble):
    """The stratified camera site (rows 0 and 1 the jitter, 2 and 3 the
    thin lens's draws) bit for bit the plain version's, from an aligned and
    a misaligned start."""
    _card()
    seeds, acc, _ = _operands(acc_kind, "int")
    card = [x.cuda() if isinstance(x, torch.Tensor) else x
            for x in (seeds, acc)]
    for start in (0, 1):
        for n in (2, 4):
            want = rng.site_draws_plain(_cut(acc, start), _cut(seeds, start),
                                        0, n, scramble, jitter=True)
            got = rng.site_draws(_cut(card[1], start), _cut(card[0], start),
                                 0, n, scramble, jitter=True)
            assert _bits_equal(got, want), (start, n)


RENDERS = {
    # the hero, 4 passes packed into one wavefront (one accumulation a lane)
    "hero": ("hero", {"max_bounces": 8, "rays_per_chunk": 1 << 17}, 4),
    # the preview: 4 bounces, 4 stratified samples a pixel, the mesh
    "preview": ("mesh", {"max_bounces": 4, "samples_per_pixel": 4,
                         "stratify_camera": True, "accel": "pallas"}, 1),
    # the other site forms: 5 BSDF draws, 4 camera draws, the scramble, and
    # the state handed to RIS's eager candidate draws
    "knobs": ("hero", {"brdf": "principled", "enable_dof": True,
                       "rng_scramble": True, "light_sampling": "ris"}, 2),
}


def _render(kind, policy, passes, device="cuda"):
    w, h = 256, 128
    if kind == "hero":
        scene = builders.default_scene(w, h)
    else:
        scene = accel.with_pallas_clusters(builders.mesh_scene(w, h,
                                                               uv_res=32))
    r = Renderer(scene, RendererPolicy(**policy), w, h, device=device)
    r.accumulate(passes)
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_equals_plain_sites(monkeypatch, name):
    """A 256x128 render's buckets bit-equal with the kernel and with
    rng.site_draws patched to the plain version; with the kernel every
    site launches it (one a chunk's camera rays, two a bounce) and nothing
    runs eagerly but the pixel seeds outside RIS's candidates."""
    _card()
    kind, policy, passes = RENDERS[name]
    r = _render(kind, policy, passes)
    profiling.clear()
    before = kernel.SITE.launches
    with profile(activities=[ProfilerActivity.CPU]):
        r.accumulate(passes)
    recs = profiling.spans()
    launched = kernel.SITE.launches - before
    counted = sum(x["counts"].get("launches.rng_site", 0) for x in recs)
    eager = sum(x["counts"].get("rng_eager_lanes", 0) for x in recs)
    bounces = sum(x["name"] == "port.bounce" for x in recs)
    cameras = sum(x["name"] == "port.camera" for x in recs)
    seeded = sum(x["attrs"]["lanes"] for x in recs
                 if x["name"] == "port.wavefront")
    assert launched == counted == cameras + 2 * bounces > 0
    # the pixel seeds stay eager: one lane a lane of each wavefront
    assert (eager > seeded > 0) == (name == "knobs")
    assert (eager == seeded) == (name != "knobs")
    got = r.state.buckets.cpu()
    monkeypatch.setattr(rng, "site_draws", rng.site_draws_plain)
    plain = _render(kind, policy, passes)
    plain.accumulate(passes)
    assert kernel.SITE.launches == before + launched
    assert _bits_equal(got, plain.state.buckets)


@pytest.mark.cuda
def test_pool_equals_plain_sites(monkeypatch):
    """render_pass_pooled (the offset one int32 a lane: each lane's own
    bounce) bit-equal with the kernel and with the plain sites."""
    _card()
    scene = builders.default_scene(64, 64).to("cuda")
    policy = RendererPolicy(max_bounces=8, rays_per_chunk=1024)
    before = kernel.SITE.launches
    got = wavefront_pool.render_pass_pooled(scene, policy, 3, 64, 64)
    assert kernel.SITE.launches > before
    monkeypatch.setattr(rng, "site_draws", rng.site_draws_plain)
    want = wavefront_pool.render_pass_pooled(scene, policy, 3, 64, 64)
    for a, b in zip(got[0], want[0]):
        assert _bits_equal(a, b)
    assert int(got[1]) == int(want[1])


@pytest.mark.cuda
def test_ao_equals_plain_sites(monkeypatch):
    """render_ao (probe k at the offset k, accumulation 2) bit-equal with
    the kernel and with the plain sites."""
    _card()
    scene = builders.default_scene(64, 64).to("cuda")
    policy = RendererPolicy()
    before = kernel.SITE.launches
    got = ao.render_ao(scene, policy, 64, 64, samples=4)
    assert kernel.SITE.launches >= before + 4
    monkeypatch.setattr(rng, "site_draws", rng.site_draws_plain)
    want = ao.render_ao(scene, policy, 64, 64, samples=4)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cpu accumulation", "int32 accumulation",
                                  "int64 offset", "short offset",
                                  "cpu offset", "strided seeds"])
def test_wrong_operands_raise_on_the_card(case):
    """Lane operands of another device, type or shape than the seeds', and
    seeds that are not contiguous, raise ValueError."""
    _card()
    seeds = _u32(5, 64).cuda()
    acc, offset = 7, 3
    if case == "cpu accumulation":
        acc = seeds.cpu()
    elif case == "int32 accumulation":
        acc = seeds.to(torch.int32)
    elif case == "int64 offset":
        offset = seeds.clone()
    elif case == "short offset":
        offset = seeds[:32].to(torch.int32)
    elif case == "cpu offset":
        offset = seeds.cpu().to(torch.int32)
    else:
        seeds = seeds[::2]
    with pytest.raises(ValueError):
        rng.site_draws(acc, seeds, offset, 3, False)
