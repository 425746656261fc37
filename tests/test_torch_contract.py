"""The contraction expressions that the port chains from its single-rounding
multiply-add (``core/fp.py``): ``fp.dot3`` (``Vec3.dot``), ``fp.fma3`` (the
three lanes of a*b + c with one b), ``sampling.to_local`` and
``sampling.to_world``, and ``to_local`` with the other contraction of its
inner sum (``fuse_xy=True``). On the card each is one launch of the fma
kernel's flat form (``ops/kernels/fma.py::contract``); on the CPU each is its
chain of ``fp.fma`` calls.

Tolerance: equal bits (NaN lanes: both NaN), against the JAX package's
functions under ``jax.jit`` (XLA on the CPU contracts a*b + c into one fused
multiply-add) on wide random floats, the double-rounding triples and the
specials of ``chip_smoke.py::fma_columns`` that give no subnormal value (XLA
on the CPU flushes those to zero); against the chains of ``fp.fma_plain``
(``fp.dot3_plain`` and the like, the kernels' plain versions) on all of
them; and how the JAX renderer's own jitted shading frame rounds
``to_local``. The host's choices of the fma kernels' forms are tested as
the pure functions they are; the ``cuda``-marked tests hold the kernels to
their plain versions on a card and skip here.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core import sampling as jsampling
from cpu_raytracing_experiments_tpu.core.vec import Quat as JQuat
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu_torch.core import fp, sampling
from cpu_raytracing_experiments_tpu_torch.core.vec import Quat, Vec3
from cpu_raytracing_experiments_tpu_torch.ops.kernels import fma as kfma
from cpu_raytracing_experiments_tpu_torch.ops.kernels import lanes
from cpu_raytracing_experiments_tpu_torch.ops.kernels import sphere_battery as sb

torch.set_num_threads(1)

N = 20_000  # random lanes of each case


def _wide(g, n):
    """Random float32 of either sign with exponents from -30 to 30."""
    return (g.uniform(1.0, 2.0, n) * 2.0 ** g.integers(-30, 31, n)
            * g.choice([-1.0, 1.0], n)).astype(np.float32)


def _columns(seed, k, subnormal=False):
    """k operand columns: N wide random floats, the double-rounding
    triples (a = 1 + j 2^-23, b = 2^-24 (1 - (j - 1) 2^-23), c = 1) in the
    first three, then every combination of a row of specials in each
    column (NaN, inf, signed zeros, exact cancellations, overflow), with
    values whose products are subnormal where `subnormal`."""
    g = np.random.default_rng(seed)
    j = np.arange(2800, 2960)
    twice = [(1.0 + j * 2.0 ** -23), 2.0 ** -24 * (1.0 - (j - 1) * 2.0 ** -23),
             np.ones(j.size)]
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 2.0, 3.0,
                -6.0, 1e30, -1e30]
    if subnormal:
        specials += [2.0 ** -75, 1.5 * 2.0 ** -75, 2.0 ** -149, 2.0 ** -100,
                     2.0 ** -50]
    s = np.array(specials)
    rows = g.integers(0, len(s), (4096, k))
    cols = []
    for i in range(k):
        cols.append(np.concatenate([
            _wide(g, N), twice[i] if i < 3 else _wide(g, j.size),
            s[rows[:, i]]]).astype(np.float32))
    return cols


def _same(x, y):
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    assert x.shape == y.shape
    nan = np.isnan(x) & np.isnan(y)
    return bool(np.all(nan | (x.view(np.int32) == y.view(np.int32))))


_t = torch.from_numpy


def _rotation(form, module, plain=False):
    """The port's to_local (either contraction of temp's inner sum) or
    to_world, or its plain version, as f(t, v)."""
    suffix = "_plain" if plain else ""
    if form == "to_world":
        return getattr(module, "to_world" + suffix)
    f = getattr(module, "to_local" + suffix)
    return lambda t, v: f(t, v, fuse_xy=form == "to_local_xy")


def _port(form, cols, scalar_b=False):
    """The port's form on CPU tensors: a tuple of numpy outputs."""
    x = [_t(c) for c in cols]
    if form == "dot3":
        out = (Vec3(*x[:3]).dot(Vec3(*x[3:])),)
    elif form == "fma3":
        b = x[3][0] if scalar_b else x[3]
        out = fp.fma3(Vec3(*x[:3]), b, Vec3(*x[4:]))
    else:
        out = _rotation(form, sampling)(
            Quat(x[0], x[1], torch.zeros_like(x[0]), x[2]), Vec3(*x[3:]))
    return tuple(o.numpy() for o in out)


def _plain(form, cols, scalar_b=False):
    """The kernel's plain version (the chain of fp.fma_plain)."""
    x = [_t(c) for c in cols]
    if form == "dot3":
        out = (fp.dot3_plain(*x),)
    elif form == "fma3":
        b = x[3][0] if scalar_b else x[3]
        out = fp.fma3_plain(Vec3(*x[:3]), b, Vec3(*x[4:]))
    else:
        out = _rotation(form, sampling, plain=True)(
            Quat(x[0], x[1], None, x[2]), Vec3(*x[3:]))
    return tuple(o.numpy() for o in out)


def _jax_form(form, scalar_b=False):
    if form == "dot3":
        return jax.jit(lambda ax, ay, az, bx, by, bz: (
            JVec3(ax, ay, az).dot(JVec3(bx, by, bz)),))
    if form == "fma3":
        return jax.jit(lambda ax, ay, az, b, cx, cy, cz: tuple(
            a * (b[0] if scalar_b else b) + c
            for a, c in ((ax, cx), (ay, cy), (az, cz))))
    f = jsampling.to_world if form == "to_world" else jsampling.to_local
    return jax.jit(lambda tx, ty, tw, vx, vy, vz: tuple(
        f(JQuat(tx, ty, jnp.zeros_like(tx), tw), JVec3(vx, vy, vz))))


ARITY = {"dot3": 6, "fma3": 7, "to_local": 6, "to_world": 6,
         "to_local_xy": 6}
CASES = [("dot3", False), ("fma3", False), ("fma3", True), ("to_local", False),
         ("to_world", False), ("to_local_xy", False)]


def _to_local_chain(cols, fuse_xy):
    """to_local as the chain of fp.fma with temp's inner sum contracted as
    fma(v.z, t.w, v.x t.y), or with `fuse_xy` as fma(v.x, t.y, v.z t.w):
    the witness of how XLA rounds each lane."""
    tx, ty, tw, vx, vy, vz = (_t(c) for c in cols)
    inner = fp.fma(vx, ty, vz * tw) if fuse_xy else fp.fma(vz, tw, vx * ty)
    temp = 2.0 * fp.fma(-tx, vy, inner)
    return tuple(o.numpy() for o in (fp.fma(-ty, temp, vx),
                                     fp.fma(tx, temp, vy),
                                     fp.fma(temp, tw, -vz)))


@pytest.mark.parametrize("form,scalar_b", CASES)
def test_form_matches_jitted_jax(form, scalar_b):
    """The port's form on the CPU against the JAX package's function under
    jax.jit, bit for bit (fma3: three a*b + c, with b an array or a 0-d
    value). to_local: XLA computes each output of the standalone function
    in its own fusion, recomputing temp = 2 (v.z t.w + v.x t.y - t.x v.y)
    in each, and fuses fma(v.z, t.w, v.x t.y) into the x and y outputs and
    fma(v.x, t.y, v.z t.w) into z: each lane is held to the witness chain
    of its contraction. The port follows the JAX renderer, which picks the
    contraction by call site (test_torch_to_local_sites.py): to_local takes
    the first in all three lanes (l_local), to_local_xy (fuse_xy=True) the
    second (v_local, n_dot_w); each equals its chain, and so the JAX
    function on the lanes it contracts alike."""
    jform = "to_local" if form == "to_local_xy" else form
    cols = _columns(11, ARITY[form])
    got = _port(form, cols, scalar_b)
    want = [np.asarray(y) for y in
            _jax_form(jform, scalar_b)(*(jnp.asarray(c) for c in cols))]
    assert len(got) == len(want)
    if jform == "to_local":
        zw, xy = _to_local_chain(cols, False), _to_local_chain(cols, True)
        assert all(_same(x, y) for x, y in zip(zw[:2], want[:2]))
        assert _same(xy[2], want[2])
        for x, y in zip(got, xy if form == "to_local_xy" else zw):
            assert _same(x, y)
        lanes = (2,) if form == "to_local_xy" else (0, 1)
        got, want = [got[i] for i in lanes], [want[i] for i in lanes]
    for x, y in zip(got, want):
        assert _same(x, y)


def test_renderer_frame_v_local_contraction():
    """How the JAX renderer's own code rounds to_local: its
    _closest_hit_frame (the shading frame bounce_step computes) under
    jax.jit, on the hit lanes of the hero's 64x64 camera rays, gives
    v_local = to_local(t, -d) with temp's inner sum contracted as
    fma(v.x, t.y, v.z t.w) in all three lanes, bit for bit; so does the
    port's to_local(fuse_xy=True), the form its _closest_hit_frame takes."""
    from cpu_raytracing_experiments_tpu.ops import intersect as jint
    from cpu_raytracing_experiments_tpu.render import renderer as jr
    from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
    from cpu_raytracing_experiments_tpu.utils.config import \
        RendererPolicy as JPolicy

    w = h = 64
    pol = JPolicy(max_bounces=6, rays_per_chunk=w * h)
    scene = jbuilders.default_scene(w, h)
    i = np.arange(w * h)
    seeds = jr.pixel_seeds(w, h, pol)
    p0, d0 = jax.jit(lambda s: jr.generate_camera_rays(
        s.camera, jnp.asarray(i % w, jnp.int32),
        jnp.asarray(i // w, jnp.int32), jnp.uint32(3), seeds, False,
        pol))(scene)
    one, zero = jnp.ones(w * h), jnp.zeros(w * h)
    state = jr.PathState(
        bounce=jnp.int32(0), p=p0, d=d0, throughput=JVec3(one, one, one),
        radiance=JVec3(zero, zero, zero), prev_pdf=zero,
        prev_delta=zero > 1.0, alive=zero < 1.0, ray_count=jnp.uint32(0))

    def frame(s, st):
        tfar, prim, is_tri = jint.intersect_scene(s, st.p, st.d)
        out = jr._closest_hit_frame(s, st, tfar, prim, is_tri)
        return out[2], out[3], prim

    t_quat, v_local, prim = jax.jit(frame)(scene, state)
    hit = np.asarray(prim) >= 0
    assert hit.sum() > 1000
    tx, ty, tw = (_t(np.array(c)) for c in (t_quat.x, t_quat.y, t_quat.w))
    vx, vy, vz = (-_t(np.array(c)) for c in d0)
    temp = 2.0 * fp.fma(-tx, vy, fp.fma(vx, ty, vz * tw))
    witness = (fp.fma(-ty, temp, vx), fp.fma(tx, temp, vy),
               fp.fma(temp, tw, -vz))
    port = sampling.to_local(Quat(tx, ty, None, tw), Vec3(vx, vy, vz),
                             fuse_xy=True)
    for x, p, y in zip(witness, port, v_local):
        assert _same(x.numpy()[hit], np.asarray(y)[hit])
        assert _same(p.numpy()[hit], np.asarray(y)[hit])


@pytest.mark.parametrize("form,scalar_b", CASES)
def test_form_on_cpu_is_its_plain_chain(form, scalar_b):
    """On the CPU each form is the chain of fp.fma_plain that the card's
    kernel is held to, subnormal values included."""
    cols = _columns(12, ARITY[form], subnormal=True)
    for x, y in zip(_port(form, cols, scalar_b), _plain(form, cols, scalar_b)):
        assert _same(x, y)


def test_cpu_operands_take_no_kernel():
    """fp.contract launches nothing for CPU operands (the chain runs), and
    the kernel's wrapper refuses them."""
    x = torch.ones(4)
    assert fp.contract(kfma.DOT3, (x,) * 6) is None
    with pytest.raises(ValueError, match="CUDA"):
        kfma.contract(kfma.DOT3, (x,) * 6)
    with pytest.raises(ValueError, match="operands"):
        kfma.contract(kfma.DOT3, (x,) * 5)


@pytest.mark.parametrize("case,flat", [
    ("same shape", True), ("0-d and floats", True), ("2-d same shape", True),
    ("all scalars", True), ("broadcast rows", False), ("size-1 dim", False),
    ("strided", False)])
def test_flat_form_rule(case, flat):
    """The flat kernel takes operands of one contiguous shape, 0-d tensors
    and Python floats; any other layout takes the strided kernel (fp.fma)
    or the chain (the fused forms)."""
    x = torch.arange(12, dtype=torch.float32)
    z = torch.tensor(2.0)
    operands = {
        "same shape": (x, x + 1, x),
        "0-d and floats": (x, z, 0.5),
        "2-d same shape": (x.reshape(3, 4), x.reshape(3, 4), z),
        "all scalars": (z, 1.5, z),
        "broadcast rows": (x.reshape(3, 4), x[:4], 1.0),
        "size-1 dim": (x, x[:1], 1.0),
        "strided": (x[::2], x[:6], 1.0),
    }[case]
    shape = kfma.flat_shape(operands)
    assert (shape is not None) == flat
    if flat:
        tensors = [o for o in operands if isinstance(o, torch.Tensor)]
        assert shape == torch.broadcast_shapes(*(t.shape for t in tensors))


@pytest.mark.parametrize("words,bytes_,n,groups", [
    ((0, 16, 4096), (), 1 << 19, 1 << 17),  # aligned, n % 4 == 0
    ((0, 16, 4096), (), 13, 3),  # aligned, a tail of 1
    ((0, 16, 4096), (), 14, 3),  # a tail of 2
    ((0, 16, 4096), (), 15, 3),  # a tail of 3
    ((0, 4, 4096), (), 1 << 19, 0),  # one operand 1 element off
    ((8, 24, 40), (), 64, 0),  # all 2 elements off: scalar loads
    ((0, 16, 12), (), 64, 0),  # an output 3 elements off
    ((0, 16), (4, 36), 64, 16),  # uint8 columns 4-byte aligned
    ((0, 16), (0, 2), 64, 0),  # a uint8 column 2 bytes off
    ((32, 48, 64), (), 64, 16),  # int64 columns 16-byte aligned
    ((32, 40), (), 64, 0),  # an int64 column 1 element off
])
def test_vector_or_scalar_path(words, bytes_, n, groups):
    """The lane kernels' 16-byte groups (``lanes.groups``, which the flat
    fma kernel takes too): n // 4 where every 4- or 8-byte column starts on
    a 16-byte boundary and every uint8 column on a 4-byte one, else none;
    the tail n % 4 and everything of a misaligned call go one lane a
    thread."""
    assert lanes.groups(n, words, bytes_) == groups
    assert 0 <= n - lanes.VECTOR * groups


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 1 << 19, (1 << 19) + 3])
def test_padded_rows_start_aligned(n):
    """A multi-output launch's rows (``lanes.rows``) are n rounded up to a
    16-byte group apart, so each row of a 16-byte-aligned buffer starts
    16-byte aligned."""
    rows = lanes.rows(3, n, "cpu")
    width = rows.stride(0)
    assert rows.shape == (3, n) and rows.dtype == torch.float32
    assert width % lanes.VECTOR == 0 and n <= width < n + lanes.VECTOR
    assert all(row.data_ptr() % 16 == 0 for row in rows)


@pytest.mark.parametrize("case, reason", [
    ("no tensor", "column 1 is not a tensor but float"),
    ("2-d column", "column 0 is 2-d, not 1-D"),
    ("wrong dtype", "column 1 is torch.int64, not torch.int32"),
    ("strided column", "column 2 is not contiguous"),
    ("short column", "column 2 is 63 lanes, not 64"),
    ("cpu columns", "column 0 is on cpu, not on a CUDA card")])
def test_columns_refuses(case, reason):
    """``lanes.columns`` raises ValueError naming the first lane column that
    is not a contiguous 1-D tensor of its dtype and the first column's
    length on one CUDA card (every column here is on the CPU)."""
    n = 64
    cols = [torch.ones(n, dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32), torch.ones(n)]
    if case == "no tensor":
        cols[1] = 1.0
    elif case == "2-d column":
        cols[0] = cols[0].view(8, 8)
    elif case == "wrong dtype":
        cols[1] = cols[1].long()
    elif case == "strided column":
        cols[2] = torch.ones(2 * n)[::2]
    elif case == "short column":
        cols[2] = cols[2][1:]
    with pytest.raises(ValueError, match=f"^lanes: {reason}"):
        lanes.columns("lanes", cols,
                      (torch.bool, torch.int32, torch.float32))


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "transposed_4d",
                                  "zero_d", "table_column"])
def test_strided_layout_replays(case):
    """The strided kernel's merged layout (``_layout``) of operands the flat
    kernel does not take: each operand read through the merged sizes and
    strides gives it broadcast to the output's shape (table_column: the
    hero's light sampler, c a column of an [n, 8] table, one dimension)."""
    base = torch.arange(3 * 5 * 7 * 9, dtype=torch.float32)
    table = base[:8 * 64].reshape(64, 8)
    operands = {
        "table_column": (base[:64], -base[64:128], table[:, 4]),
        "contiguous": (base[:60].reshape(6, 10), base[:60].reshape(6, 10),
                       2.0),
        "broadcast": (base[:256].reshape(256, 1), base[:64].reshape(1, 64),
                      base[:1].reshape(1, 1)),
        "transposed_4d": (base.reshape(3, 5, 7, 9).transpose(1, 2),
                          base[:45].reshape(1, 5, 1, 9).transpose(1, 2),
                          0.75),
        "zero_d": (base.reshape(3, 5, 7, 9).transpose(1, 2),
                   base[:45].reshape(1, 5, 1, 9).transpose(1, 2),
                   base[7]),
    }[case]
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))
    sizes, strides = kfma._layout(shape, operands)
    assert len(sizes) <= kfma.MAX_DIMS
    if case == "table_column":
        assert kfma.flat_shape(operands) is None
        assert sizes == [64] and strides == [[1], [1], [8]]
    assert int(np.prod(sizes)) == int(np.prod(shape))
    for x, st in zip(operands, strides):
        if not isinstance(x, torch.Tensor):
            assert all(v == 0 for v in st)
            continue
        replay = torch.as_strided(x, sizes, st, x.storage_offset())
        assert torch.equal(replay.reshape(shape), x.expand(shape))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("form,scalar_b", CASES)
def test_fused_form_matches_plain_on_card(form, scalar_b):
    """Each fused form on the card: one launch, equal bits to its plain
    chain, aligned, at an offset of one element and with a ragged end."""
    _card()
    cols = _columns(13, ARITY[form], subnormal=True)
    for lanes in (slice(0, None), slice(1, None), slice(0, N + 3)):
        x = [_t(c[lanes]).cuda() for c in cols]
        counter = kfma.COUNTERS[{"dot3": kfma.DOT3, "fma3": kfma.FMA3,
                                 "to_local": kfma.TO_LOCAL,
                                 "to_world": kfma.TO_WORLD,
                                 "to_local_xy": kfma.TO_LOCAL_XY}[form]]
        before = counter.launches
        if form == "dot3":
            got = (fp.dot3(*x),)
        elif form == "fma3":
            got = fp.fma3(Vec3(*x[:3]), x[3][0] if scalar_b else x[3],
                          Vec3(*x[4:]))
        else:
            got = _rotation(form, sampling)(Quat(x[0], x[1], None, x[2]),
                                            Vec3(*x[3:]))
        assert counter.launches == before + 1
        want = _plain(form, [c[lanes] for c in cols], scalar_b)
        for a, b in zip(got, want):
            assert _same(a.cpu().numpy(), b)


@pytest.mark.cuda
def test_sphere_closest_matches_plain_on_card():
    """sphere_closest on the card against the plain version, on tables of 9
    and 1025 spheres with ties and on misaligned, ragged ray slices."""
    _card()
    g = np.random.default_rng(17)
    n = 4099
    o = torch.tensor(g.uniform(-20, 20, (3, n)), dtype=torch.float32).cuda()
    d = torch.tensor(g.normal(size=(3, n)), dtype=torch.float32).cuda()
    for count in (9, 1025):
        c = g.uniform(-15, 15, (3, count // 2 + 1))
        c = np.concatenate([c, c], 1)[:, :count]  # ties
        center = Vec3(*torch.tensor(c, dtype=torch.float32).cuda())
        rsq = torch.tensor(g.uniform(0.5, 9.0, count // 2 + 1),
                           dtype=torch.float32).repeat(2)[:count].cuda()
        for off in (0, 1, 3):
            p = Vec3(*(a[off:] for a in o))
            dd = Vec3(*(a[off:] for a in d))
            wt, wid = sb.intersect_spheres(p, dd, center, rsq)
            kt, kid = sb.closest_hit(p, dd, center, rsq)
            assert torch.equal(kid, wid)
            assert torch.equal(kt.view(torch.int32), wt.view(torch.int32))
