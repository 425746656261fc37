"""The PyTorch port's uniform grid (``bvh/grid.py``,
``scene/accel.py::with_grid``) against the JAX package's, on the CPU.

The build gives the JAX package's arrays exactly, the overflow / residual
case included (after tests/test_grid.py), and both DDA walks give jitted
JAX's tfar bits, prim ids and occlusion bits exactly, with and without a
residual list, over spheres and triangles, on seeded rays among which a
quarter are exactly axis-aligned or have an exact zero in the origin, and
many miss the grid's box. The ``cuda`` test holds the kernels of
``ops/kernels/grid_walk.py`` to these plain forms on a card."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.bvh import grid as jgrid
from cpu_raytracing_experiments_tpu.bvh import traverse as jtraverse
from cpu_raytracing_experiments_tpu.scene import accel as jaccel
from cpu_raytracing_experiments_tpu.scene import builders as jbuilders
from cpu_raytracing_experiments_tpu_torch.bvh import grid as tgrid
from cpu_raytracing_experiments_tpu_torch.bvh import traverse as ttraverse
from cpu_raytracing_experiments_tpu_torch.ops.kernels import grid_walk
from cpu_raytracing_experiments_tpu_torch.scene import accel as taccel
from cpu_raytracing_experiments_tpu_torch.scene import builders as tbuilders

from test_torch_bvh import FLT_MAX, bits, jv, rays, spheres, triangles, tv
from test_torch_scene import (_assert_same_arrays, jax_grid_to_numpy,
                              jax_scene_to_numpy)

torch.set_num_threads(1)

# (kind, prim count, res, max_per_cell): the two residual cases overflow
# their cells (tests/test_grid.py::test_grid_with_overflow_residual)
CASES = {
    "sphere": ("sphere", 400, 16, 24),
    "sphere residual": ("sphere", 200, 4, 2),
    "triangle": ("triangle", 600, 8, 32),
    "triangle residual": ("triangle", 600, 6, 4),
}


def _bounds(kind, n):
    if kind == "sphere":
        c, r = spheres(n, 3)
        return c - r[:, None], c + r[:, None], (c, r * r)
    v0, v1, v2 = triangles(n, 4)
    return (np.minimum(np.minimum(v0, v1), v2),
            np.maximum(np.maximum(v0, v1), v2), (v0, v1 - v0, v2 - v0))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    kind, n, res, k = CASES[request.param]
    mins, maxs, prims = _bounds(kind, n)
    jg = jgrid.build_grid(mins, maxs, res=res, max_per_cell=k)
    tg = tgrid.build_grid(mins, maxs, res=res, max_per_cell=k)
    if kind == "sphere":
        c, rsq = prims
        rows = (jtraverse.pack_spheres(jv(c), jnp.asarray(rsq)),
                ttraverse.pack_spheres(tv(c), torch.from_numpy(rsq)))
        tests = (jtraverse.sphere_row_test, ttraverse.sphere_row_test)
        p, d = rays(3000, 5, -100, 100)
        tfar = 80.0
    else:
        rows = (jtraverse.pack_triangles(*(jv(a) for a in prims)),
                ttraverse.pack_triangles(*(tv(a) for a in prims)))
        tests = (jtraverse.triangle_row_test, ttraverse.triangle_row_test)
        p, d = rays(3000, 6, -30, 30)
        tfar = 25.0
    return {"name": request.param, "grid": (jg, tg), "rows": rows,
            "tests": tests, "rays": (p, d), "tfar": tfar}


def test_build_grid_equals_jax(case):
    """bvh/grid.py::build_grid: origin, 1/cell, cell size, the cell table,
    the counts and the sorted residual equal to the JAX package's; the
    residual cases do overflow."""
    jg, tg = case["grid"]
    _assert_same_arrays(tg.to_numpy(), jax_grid_to_numpy(jg))
    assert (tg.residual.shape[0] > 0) == case["name"].endswith("residual")


@pytest.mark.parametrize("shadow", [False, True], ids=["closest", "shadow"])
def test_walks_bit_equal_jax(case, shadow):
    """traverse_grid_closest (walk, then the residual battery) and
    traverse_grid_shadow (residual first, then the walk) against jitted JAX
    (bvh/grid.py): tfar bits and prim ids, or occlusion bits, exactly
    equal. Closest walks start from FLT_MAX with every fifth lane at 20;
    shadow walks take a fixed tfar with every seventh lane disabled."""
    jg, tg = case["grid"]
    p, d = case["rays"]
    tf = np.full(p.shape[0], FLT_MAX, np.float32)
    tf[::5] = 20.0
    if shadow:
        tf = np.full(p.shape[0], case["tfar"], np.float32)
        tf[::7] = 0.0
    jrows, trows = case["rows"]
    jtest, ttest = case["tests"]
    if shadow:
        want = jax.jit(lambda g, p, d, t: jgrid.traverse_grid_shadow(
            g, p, d, t, jrows, jtest))(jg, jv(p), jv(d), jnp.asarray(tf))
        got = tgrid.traverse_grid_shadow(tg, tv(p), tv(d),
                                         torch.from_numpy(tf), trows, ttest)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.01 < got.float().mean() < 0.5
        return
    want = jax.jit(lambda g, p, d, t: jgrid.traverse_grid_closest(
        g, p, d, jrows, jtest, tfar0=t))(jg, jv(p), jv(d), jnp.asarray(tf))
    got = tgrid.traverse_grid_closest(tg, tv(p), tv(d), trows, ttest,
                                      tfar0=torch.from_numpy(tf))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
    assert 0.01 < (got[1] >= 0).float().mean() < 0.5


def test_rays_that_miss_the_grid():
    """Rays that start outside the grid's box and point away from it, and
    rays inside it with tfar = 0: no walk, tfar0 and -1 kept, nothing
    occluded; jitted JAX gives the same bits."""
    mins, maxs, (c, rsq) = _bounds("sphere", 100)
    jg = jgrid.build_grid(mins, maxs, res=8, max_per_cell=16)
    tg = tgrid.build_grid(mins, maxs, res=8, max_per_cell=16)
    n = 256
    g = np.random.default_rng(9)
    p = g.uniform(200, 300, (n, 3)).astype(np.float32)
    d = np.abs(g.normal(size=(n, 3))).astype(np.float32) + 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jrows = jtraverse.pack_spheres(jv(c), jnp.asarray(rsq))
    trows = ttraverse.pack_spheres(tv(c), torch.from_numpy(rsq))
    want = jax.jit(lambda g_, p, d: jgrid.traverse_grid_closest(
        g_, p, d, jrows, jtraverse.sphere_row_test))(jg, jv(p), jv(d))
    got = tgrid.traverse_grid_closest(tg, tv(p), tv(d), trows,
                                      ttraverse.sphere_row_test)
    assert (got[1] == -1).all()
    np.testing.assert_array_equal(bits(got[0].numpy()), bits(want[0]))
    inside = np.zeros((n, 3), np.float32)
    occ = tgrid.traverse_grid_shadow(tg, tv(inside), tv(d), torch.zeros(n),
                                     trows, ttraverse.sphere_row_test)
    assert not occ.any()


@pytest.mark.parametrize("name", ["bvh_test_scene", "cornell_box_scene"])
def test_with_grid_equals_jax(name):
    """scene/accel.py::with_grid: the sphere and triangle grids equal the
    JAX package's (nothing else of the scene changes)."""
    want = jax_scene_to_numpy(jaccel.with_grid(getattr(jbuilders, name)(
        16, 16), res=8, max_per_cell=4))
    got = taccel.with_grid(getattr(tbuilders, name)(16, 16), res=8,
                           max_per_cell=4).to_numpy()
    _assert_same_arrays(got, want)


@pytest.mark.cuda
def test_kernels_match_plain_on_card(case):
    """csrc/grid_walk.cu on a CUDA card: grid_closest and grid_occluded,
    residual included, equal their plain versions bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    tg = case["grid"][1].to("cuda")
    rows = case["rows"][1].to("cuda")
    test = case["tests"][1]
    p, d = (tv(a).to("cuda") for a in case["rays"])
    tf = torch.full((p.x.shape[0],), case["tfar"], device="cuda")
    kt, kid = grid_walk.closest(tg, p, d, rows)
    pt, pid = tgrid.traverse_grid_closest(tg, p, d, rows, test)
    assert torch.equal(kid, pid)
    assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
    assert torch.equal(grid_walk.occluded(tg, p, d, tf, rows),
                       tgrid.traverse_grid_shadow(tg, p, d, tf, rows, test))


@pytest.mark.parametrize("n_rays,n_residual,want", [
    (1 << 16, 33576, (17, 2048)),  # the mesh grid's residual at 2^16 rays
    (1 << 19, 33576, (3, 11264)),  # and at the pass's chunk width
    (100, 5, (1, 128)),
    (1000, 700, (1, 768)),
    (4096, 0, (1, 0)),
    (1, 1 << 20, (2048, 512)),
])
def test_residual_split(n_rays, n_residual, want):
    """ops/kernels/grid_walk.py::residual_split, the grid kernels' split of
    the residual battery across blocks on a 132-SM card: whole 128-row
    tiles, at least 4 a slice where there are several, no slice empty, the
    slices covering the residual, and enough of them for 16 blocks an SM
    where the residual is long enough."""
    slices, rows = grid_walk.residual_split(n_rays, n_residual, 132)
    assert (slices, rows) == want
    assert rows % grid_walk.ROW_TILE == 0
    if n_residual:
        assert (slices - 1) * rows < n_residual <= slices * rows
    if slices > 1:
        assert rows >= grid_walk.MIN_SLICE_TILES * grid_walk.ROW_TILE
