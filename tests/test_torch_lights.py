"""The port's light selection functions against the JAX package's, on the
CPU: the alias table (``scene.py::build_light_alias`` / ``_vose_alias``),
the light-row reductions in XLA's order (``core/fp.py`` ``row_sum`` /
``row_cumsum`` and ``ops/kernels/light_rows.py``'s plain version),
``_light_selection_weights``, ``_select_light`` ('power', 'alias'),
``_hit_light_selection_pdf``, ``_select_light_ris``,
``_select_light_restir`` (1-D lanes, 2-D raster and tile order, spp 1 and 2,
rejection on and off), ``core/ris.py`` and ``scene/sky_models.py``.

Every comparison is bit for bit against the JAX function called under
``jax.jit`` (XLA contracts a*b + c there and fixes its summation orders),
on inputs made from a numpy seed. Where a JAX function jitted alone rounds
a reduction otherwise than the renderer's program does, the test names the
form: the emissive-hit pdf's row sum is fused with its weights in both
(``row_sum(fused=True)``), the selection's total is not.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core import ris as jris
from cpu_raytracing_experiments_tpu.core import rng as jrng
from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.render import renderer as jr
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu.scene import scene as jscene
from cpu_raytracing_experiments_tpu.scene import sky_models as jsky
from cpu_raytracing_experiments_tpu.scene.builders import _SceneBuilder
from cpu_raytracing_experiments_tpu.utils.config import RendererPolicy as JPolicy
from cpu_raytracing_experiments_tpu_torch.core import fp, ris, rng
from cpu_raytracing_experiments_tpu_torch.core.vec import Vec3 as TVec3
from cpu_raytracing_experiments_tpu_torch.ops.kernels import light_rows
from cpu_raytracing_experiments_tpu_torch.render import renderer as tr
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders
from cpu_raytracing_experiments_tpu_torch.scene import scene as tscene
from cpu_raytracing_experiments_tpu_torch.scene import sky_models as tsky
from cpu_raytracing_experiments_tpu_torch.utils.config import RendererPolicy

from test_light_sampling import _many_light_scene
from test_torch_scene import jax_scene_to_numpy

torch.set_num_threads(1)

LIGHTS = [1, 3, 16, 17, 18, 64, 326, 512]
LANES = 50_000


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


def _same(a, b):
    return np.array_equal(_bits(a), _bits(b))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def emitter_scene(lights: int, seed: int = 11):
    """A floor under `lights` emissive spheres of random emission and
    radius (test_light_sampling.py's 512-emitter scene at any count)."""
    b = _SceneBuilder()
    floor = b.material(albedo=(0.8, 0.8, 0.8), roughness=1.0)
    b.sphere((0.0, -100.5, 0.0), 100.0, floor)
    g = np.random.default_rng(seed)
    for _ in range(lights):
        em = float(g.uniform(0.5, 60.0))
        m = b.material(emission=(em, em * 0.9, em * 0.7), albedo=(1, 1, 1))
        b.sphere((float(g.uniform(-40, 40)), float(g.uniform(2, 50)),
                  float(g.uniform(-40, 40))), float(g.uniform(0.1, 0.5)), m)
    cam = jscene.Camera.create(eye=(0, 3, 30), forward=(0, -0.1, -1),
                               width=24, height=24)
    return b.build(cam, jscene.Sky.constant((0.0, 0.0, 0.0)))


def scenes(jsc):
    return jsc, tscene.Scene.from_numpy(jax_scene_to_numpy(jsc), device="cpu")


def points(n, seed):
    """n shading points over the emitters' field, as JAX and port Vec3s."""
    g = np.random.default_rng(seed)
    p = np.stack([g.uniform(-50, 50, n), g.uniform(-1, 60, n),
                  g.uniform(-50, 50, n)], 1).astype(np.float32)
    return (JVec3(*(jnp.asarray(p[:, k]) for k in range(3))),
            TVec3(*(_t(p[:, k]) for k in range(3))))


# ---------------------------------------------------------------- alias ---
def _alias_scene(name):
    if name == "many_light":
        return _many_light_scene()
    if name == "emitters512":
        return emitter_scene(512)
    return getattr(jbuilders, name)(32, 32)


@pytest.mark.parametrize("name", ["default_scene", "many_light",
                                  "emitters512", "cornell_box_scene"])
def test_light_alias_matches_jax(name):
    """scene.py::build_light_alias on the hero (3 lights), the 16-light
    many-light scene, the 512-emitter scene and cornell (triangle lights):
    the port's host build from the scene's arrays gives the JAX table and
    per-prim pdfs bit for bit; the port's own builders attach the same."""
    jsc = _alias_scene(name)
    arrays = jax_scene_to_numpy(jsc)
    want = {k: arrays.pop(k) for k in list(arrays)
            if k.startswith("light_alias_")}
    assert want["light_alias_table"].shape == (
        int(jsc.lights.shape[0]) + (0 if jsc.tri_lights is None
                                    else int(jsc.tri_lights.shape[0])), 4)
    got = tscene.light_alias_arrays(arrays)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and _same(got[k], want[k]), k
    if name in ("default_scene", "cornell_box_scene"):
        port = getattr(tbuilders, name)(32, 32).light_alias
        assert _same(port.table.numpy(), want["light_alias_table"])
        assert _same(port.sphere_pdf.numpy(), want["light_alias_sphere_pdf"])


def test_vose_alias_matches_jax():
    """_vose_alias on random pmfs of 1-700 bins (with zero and equal
    weights): equal prob and alias, as the list pops order them."""
    g = np.random.default_rng(2)
    for n in (1, 2, 7, 64, 700):
        w = g.gamma(0.5, 1.0, n)
        w[g.random(n) < 0.2] = 0.0
        w[: n // 3] = w[0]
        p = w / w.sum() if w.sum() > 0 else np.full(n, 1.0 / n)
        want, got = jscene._vose_alias(p), tscene._vose_alias(p)
        assert _same(got[0], want[0]) and np.array_equal(got[1], want[1])


# ----------------------------------------------------- row reductions ---
@pytest.mark.parametrize("lights", LIGHTS + [33, 1025, 10817])
def test_row_reductions_match_jax(lights):
    """fp.row_sum and fp.row_cumsum against jitted jnp.sum / jnp.cumsum over
    the lights, bit for bit (random weights over six decades, a tenth
    zero); and light_rows' plain version against the same selection made
    from the JAX arrays."""
    g = np.random.default_rng(lights)
    rows = 2000 if lights < 1000 else 200
    w = (g.random((rows, lights), dtype=np.float32)
         * np.float32(10) ** g.integers(-3, 3, (rows, lights)).astype(
             np.float32)).astype(np.float32)
    w[g.random((rows, lights)) < 0.1] = 0.0
    total = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(w))
    cdf = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(w))
    assert _same(fp.row_sum(_t(w)).numpy(), total)
    assert _same(fp.row_cumsum(_t(w)).numpy(), cdf)
    f = g.random(rows, dtype=np.float32)
    t, sel, p = light_rows.light_rows(_t(w), _t(f))
    count = (cdf <= (f * total)[:, None]).sum(axis=1)
    want_sel = np.clip(count, 0, lights - 1)
    assert _same(t.numpy(), total)
    assert np.array_equal(sel.numpy(), want_sel)
    assert _same(p.numpy(), w[np.arange(rows), want_sel]
                 / np.maximum(total, np.float32(1e-30)))


# --------------------------------------------------- selection weights ---
def _hit_pdf_total(jsc, jp):
    return jax.jit(lambda s, p: jnp.maximum(jnp.sum(
        jr._light_selection_weights(s, p), axis=1), 1e-30))(jsc, jp)


@pytest.mark.parametrize("lights", [1, 3, 11, 12, 15, 16, 17, 23, 24, 31,
                                    32, 33, 64])
def test_fused_row_sum_matches_jax(lights):
    """The row total as the emissive-hit pdf forms it: XLA fuses the sum
    with the weights and lets LLVM vectorize it in lanes of 8 up to 32
    lights (``fp.row_sum(fused=True)``), against jitted JAX on 4,000
    points; the unfused order differs from 12 lights on."""
    jsc, tsc = scenes(emitter_scene(lights))
    jp, tp = points(4000, 5)
    want = np.asarray(_hit_pdf_total(jsc, jp))
    w = tr._light_selection_weights(tsc, tp)
    assert _same(torch.clamp_min(fp.row_sum(w, fused=True), 1e-30).numpy(),
                 want)
    plain = torch.clamp_min(fp.row_sum(w), 1e-30).numpy()
    assert _same(plain, want) == (lights < 12 or lights > 32)


def _policies(mode, **knobs):
    return (JPolicy(light_sampling=mode, **knobs),
            RendererPolicy(light_sampling=mode, **knobs))


@pytest.mark.parametrize("lights", LIGHTS)
def test_select_light_matches_jax(lights):
    """_light_selection_weights and _select_light under 'power' and 'alias'
    on 50,000 points: weights, selections and pdfs bit for bit against
    jitted JAX. Half the power draws sit on an entry of XLA's running sum,
    where a sum taken in another order selects another light (asserted
    from 18 lights on, where XLA's order is not sequential)."""
    jsc, tsc = scenes(emitter_scene(lights))
    jp, tp = points(LANES, 3)
    g = np.random.default_rng(lights + 100)
    w_j = np.asarray(jax.jit(jr._light_selection_weights)(jsc, jp))
    w_t = tr._light_selection_weights(tsc, tp)
    assert _same(w_t.numpy(), w_j)
    f = g.random(LANES, dtype=np.float32)
    total = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(w_j))
    cdf = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(w_j))
    on = g.random(LANES) < 0.5
    j = g.integers(0, lights, LANES)
    at = (cdf[np.arange(LANES), j].astype(np.float64)
          / np.maximum(total, 1e-30)).astype(np.float32)
    f = np.where(on, at, f).astype(np.float32)
    if lights >= 18:
        seq = np.cumsum(w_j, axis=1, dtype=np.float32)
        target = (f * total)[:, None]
        assert ((seq <= target).sum(1) != (cdf <= target).sum(1)).any()
    for mode in ("power", "alias"):
        jpol, tpol = _policies(mode)
        sj, pj = jax.jit(lambda s, p, ff: jr._select_light(
            s, jpol, p, ff, lights))(jsc, jp, jnp.asarray(f))
        st, pt = tr._select_light(tsc, tpol, tp, _t(f), lights)
        pt = pt.numpy() if isinstance(pt, torch.Tensor) else pt
        assert np.array_equal(st.numpy(), np.asarray(sj)), mode
        assert _same(np.broadcast_to(np.float32(pt), (LANES,)),
                     np.broadcast_to(np.asarray(pj), (LANES,))), mode


def _path_state(jp, tp):
    z = jp.x * 0.0
    js = jr.PathState(bounce=jnp.int32(1), p=jp, d=jp, throughput=jp,
                      radiance=jp, prev_pdf=z, prev_delta=z > 0,
                      alive=z < 1, ray_count=jnp.uint32(0))
    ts = tr.PathState(bounce=1, p=tp, d=tp, throughput=tp, radiance=tp,
                      prev_pdf=tp.x * 0, prev_delta=tp.x > 1e30,
                      alive=tp.x < 1e30,
                      ray_count=torch.zeros((), dtype=torch.int64))
    return js, ts


@pytest.mark.parametrize("name,lights", [("emitters", 17), ("emitters", 64),
                                         ("emitters", 326),
                                         ("cornell_box_scene", None)])
def test_hit_light_selection_pdf_matches_jax(name, lights):
    """_hit_light_selection_pdf under 'power' and 'alias' for hit prims
    drawn over every sphere (lights and not, and misses), and on cornell
    over its triangles too: bit for bit against jitted JAX."""
    jsc = (emitter_scene(lights) if name == "emitters"
           else jbuilders.cornell_box_scene(32, 32))
    jsc, tsc = scenes(jsc)
    n = 20_000
    jp, tp = points(n, 7)
    if name != "emitters":
        # inside the box
        jp = JVec3(*(c * 0.01 for c in jp))
        tp = TVec3(*(c * 0.01 for c in tp))
    g = np.random.default_rng(9)
    n_s = int(jsc.spheres.radius_sq.shape[0])
    n_t = 0 if jsc.triangles is None else int(jsc.triangles.area.shape[0])
    is_tri = g.random(n) < (0.5 if n_t else 0.0)
    prim = np.where(is_tri, g.integers(0, max(n_t, 1), n),
                    g.integers(-1, n_s, n)).astype(np.int32)
    count = int(jsc.lights.shape[0]) + (0 if jsc.tri_lights is None else
                                        int(jsc.tri_lights.shape[0]))
    js, ts = _path_state(jp, tp)
    for mode in ("power", "alias"):
        jpol, tpol = _policies(mode)
        want = jax.jit(lambda s, st, pr, it: jr._hit_light_selection_pdf(
            s, jpol, st, pr, it, count))(jsc, js, jnp.asarray(prim),
                                         jnp.asarray(is_tri))
        got = tr._hit_light_selection_pdf(tsc, tpol, ts, _t(prim),
                                          _t(is_tri), count)
        assert _same(got.numpy(), np.asarray(want)), mode


# ---------------------------------------------------------- RIS, ReSTIR ---
def _sites(n, seed):
    s = np.random.default_rng(seed).integers(0, 2 ** 32, n, dtype=np.uint64)
    return s.astype(np.uint32)


@pytest.mark.parametrize("lights", [3, 17, 326])
def test_select_light_ris_matches_jax(lights):
    """_select_light_ris: the RNG site, the selection and W bit for bit (XLA
    folds 0 + w0 and fuses w0's product into w0 + w1, then each new
    product into the sum)."""
    jsc, tsc = scenes(emitter_scene(lights))
    jp, tp = points(20_000, 4)
    site = _sites(20_000, lights)
    jpol, tpol = _policies("ris")
    want = jax.jit(lambda s, p, st: jr._select_light_ris(
        s, jpol, p, st, lights))(jsc, jp, jnp.asarray(site))
    got = tr._select_light_ris(tsc, tpol, tp, _t(site.astype(np.int64)),
                               lights)
    for a, b in zip(got, want):
        assert _same(a.numpy(), b)


RESTIR = [
    pytest.param("lanes", 1, True, id="1d"),
    pytest.param("raster", 1, True, id="2d_raster"),
    pytest.param("raster", 2, False, id="2d_raster_spp2_no_reject"),
    pytest.param("tile", 1, True, id="2d_tile"),
    pytest.param("tile", 2, False, id="2d_tile_spp2_no_reject"),
]


@pytest.mark.parametrize("order,spp,reject", RESTIR)
def test_select_light_restir_matches_jax(order, spp, reject):
    """_select_light_restir on 100x60 lanes (the 326-light scene's weights
    at random points): random incoming reservoirs, the lanes' local pixel
    coordinates in raster or 16x16 tile order with 1 or 2 samples a pixel,
    normals and hit distances that pass and fail the geometry test; the
    site, selection, W and the reservoirs out bit for bit."""
    lights, width, n = 326, 100, 6000
    jsc, tsc = scenes(emitter_scene(lights))
    jp, tp = points(n, 12)
    g = np.random.default_rng(13)
    s_in = g.integers(-1, lights, n).astype(np.int32)
    w_in = g.gamma(1.0, 0.01, n).astype(np.float32)
    c_in = g.integers(0, 12, n).astype(np.float32)
    nrm = g.normal(size=(n, 3)) + np.where(g.random((n, 1)) < 0.7, 4.0, 0.0)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    dist = g.uniform(5.0, 6.5, n).astype(np.float32)
    site = _sites(n, 14)
    jpol, tpol = _policies("restir", restir_reject=reject)
    args = (jsc, jp, jnp.asarray(site), jnp.asarray(s_in), jnp.asarray(w_in),
            jnp.asarray(c_in))
    kw_t = {}
    if order == "lanes":
        want = jax.jit(lambda s, p, st, a, b, c: jr._select_light_restir(
            s, jpol, p, st, lights, (a, b, c)))(*args)
    else:
        wdt = width // spp
        pos = np.arange(n) // spp
        loc = (jr._tile_pixel_order_np(wdt, n // spp, 16)[pos]
               if order == "tile" else pos)
        x, y = (loc % wdt).astype(np.int32), (loc // wdt).astype(np.int32)
        geom = (order, wdt, 16 if order == "tile" else 0, spp)
        want = jax.jit(lambda s, p, st, a, b, c, gn, gd, xx, yy:
                       jr._select_light_restir(
                           s, jpol, p, st, lights, (a, b, c),
                           guides=(gn, gd), xy=(xx, yy), geom=geom))(
            *args, JVec3(*(jnp.asarray(nrm[:, k]) for k in range(3))),
            jnp.asarray(dist), jnp.asarray(x), jnp.asarray(y))
        kw_t = dict(guides=(TVec3(*(_t(nrm[:, k]) for k in range(3))),
                            _t(dist)),
                    xy=(_t(x.astype(np.int64)), _t(y.astype(np.int64))),
                    geom=geom)
    got = tr._select_light_restir(
        tsc, tpol, tp, _t(site.astype(np.int64)), lights,
        (_t(s_in.astype(np.int64)), _t(w_in), _t(c_in)), **kw_t)
    for a, b in zip(got[:3], want[:3]):
        assert _same(a.numpy(), b)
    for a, b in zip(got[3], want[3]):
        assert _same(a.numpy(), b)
    assert (np.asarray(want[3][0]) >= 0).mean() > 0.5


def test_core_ris_matches_jax():
    """core/ris.py: Reservoir.update, ris and combine_reservoirs with the
    same source and target functions in both packages (a uniform source
    over 37 candidates, a tabulated target with zeros), bit for bit."""
    n, m = 5000, 37
    g = np.random.default_rng(21)
    table = g.gamma(0.8, 1.0, (n, m)).astype(np.float32)
    table[g.random((n, m)) < 0.2] = 0.0
    site = _sites(n, 22)

    tbl_j, tbl_t = jnp.asarray(table), _t(table)

    def jsrc(i, state):
        state, u = jrng.rand_unit_float(state)
        cand = jnp.minimum((u * m).astype(jnp.int32), m - 1)
        return state, cand, jnp.full((n,), float(m), jnp.float32)

    def jtarget(c):
        return jnp.take_along_axis(tbl_j, c[:, None], axis=1)[:, 0]

    def tsrc(i, state):
        state, u = rng.rand_unit_float(state)
        cand = torch.clamp_max((u * float(m)).to(torch.int32), m - 1)
        return state, cand, torch.full((n,), float(m))

    def ttarget(c):
        return tbl_t.gather(1, c.to(torch.int64)[:, None])[:, 0]

    want = jax.jit(lambda s: jris.ris(4, jsrc, jtarget, s))(jnp.asarray(site))
    got = ris.ris(4, tsrc, ttarget, _t(site.astype(np.int64)))
    for a, b in zip(got, want):
        assert _same(a.numpy(), b)
    # three reservoirs merged
    parts = []
    for k in range(3):
        s = g.integers(-1, m, n).astype(np.int32)
        parts.append((s, g.gamma(1.0, 0.1, n).astype(np.float32),
                      g.gamma(1.0, 1.0, n).astype(np.float32),
                      g.integers(0, 9, n).astype(np.int32)))
    jres = [jris.Reservoir(*(jnp.asarray(a) for a in p)) for p in parts]
    tres = [ris.Reservoir(*(_t(a) for a in p)) for p in parts]
    want = jax.jit(lambda rs, s: jris.combine_reservoirs(rs, jtarget, s))(
        jres, jnp.asarray(site))
    got = ris.combine_reservoirs(tres, ttarget, _t(site.astype(np.int64)))
    assert _same(got[0].numpy(), want[0])
    for a, b in zip(got[1], want[1]):
        assert _same(a.numpy(), b)
    empty = ris.Reservoir.empty((4,))
    assert empty.sample.tolist() == [-1] * 4 and empty.count.sum() == 0


# ------------------------------------------------------------------ sky ---
@pytest.mark.parametrize("fn,kw", [
    ("clear_sky", {}),
    ("clear_sky", {"width": 64, "height": 32, "sun_direction": (-0.2, 0.3,
                                                                0.9)}),
    ("studio_gradient", {}),
])
def test_sky_models_match_jax(fn, kw):
    """scene/sky_models.py: the maps equal the JAX package's bit for bit."""
    want = getattr(jsky, fn)(**kw)
    got = getattr(tsky, fn)(**kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _same(got, want)


# ---------------------------------------------------------------- card ---
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the light_rows kernel has no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_light_rows_matches_plain_on_card(fused):
    """light_rows on the card against its plain version at every count of
    LIGHTS, on draws that sit on the running sum's entries."""
    _card()
    g = np.random.default_rng(31)
    for lights in LIGHTS:
        w = g.gamma(0.5, 1.0, (4096, lights)).astype(np.float32)
        f = g.random(4096, dtype=np.float32)
        want = light_rows.rows_plain(_t(w), _t(f), fused)
        before = light_rows.LIGHT_ROWS.launches
        got = light_rows.light_rows(_t(w).cuda(), _t(f).cuda(), fused)
        assert light_rows.LIGHT_ROWS.launches == before + 1
        for a, b in zip(got, want):
            assert _same(a.cpu().numpy(), b.numpy())
