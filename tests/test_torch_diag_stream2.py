"""The port's ``diag/stream2.py`` (the streamed closest walk checked visit by
visit) against the JAX package's ``benchmarks/diag_stream2.py`` and the
Pallas kernels it launches, on the CPU, at a small size: 3,000 random
triangles in clusters of K = 128 (C = 24), 2,048 rays, tiles of 256 rays.

The JAX side runs its Pallas kernels with ``interpret=True``: the planner,
the streamed walk ``_stream_kernels(shadow=False)`` with nvis clamped to a
prefix m, and a copy of the script's DMA-replay kernel (the script defines
it inside ``main()``). Tolerance: equal bits, for the visit lists, the
replayed rows and the prefix walks' tfar and ids. The CUDA kernels are held
to the same plain versions on the card by ``chip_smoke.py`` phase 15.
"""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.experimental.pallas as pl
from jax.experimental.pallas import tpu as pltpu
import torch

from cpu_raytracing_experiments_tpu.core.vec import Vec3 as JVec3
from cpu_raytracing_experiments_tpu.ops import clustered as jcl
from cpu_raytracing_experiments_tpu.ops.pallas import traverse_kernel as jtk
from cpu_raytracing_experiments_tpu_torch.diag import stream2 as s2
from cpu_raytracing_experiments_tpu_torch.ops.kernels import \
    cluster_traverse as ct

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import bench_stream  # noqa: E402

torch.set_num_threads(1)

N_PRIMS, K, N_RAYS, TILE = 3000, 128, 2048, s2.TILE
TILES = (0, 3)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def packs():
    """The JAX script's build() at the small size in both packages: the
    JAX pack, the port's pack and rays (the port's build), and the JAX
    rays."""
    rng = np.random.default_rng(s2.SEED)
    mins, maxs, rows = bench_stream.make_tris(N_PRIMS, rng)
    jcp = jcl.build_clusters(mins, maxs, rows,
                             num_clusters=-(-N_PRIMS // K), kind="triangle")
    jp, jd = bench_stream.make_rays(N_RAYS, rng)
    tcp, tp, td = s2.build("cpu", prims=N_PRIMS, k=K, rays=N_RAYS)
    return jcp, jp, jd, tcp, tp, td


def _jax_tile(jp, jd, tile):
    """The tile's ray columns as the JAX script builds them, padded to the
    8-tile grid."""
    sl = slice(tile * TILE, (tile + 1) * TILE)
    ps, ds = JVec3(*(a[sl] for a in jp)), JVec3(*(a[sl] for a in jd))
    return jtk._ray_cols(
        [(ps.x, 1e30), (ps.y, 1e30), (ps.z, 1e30), (ds.x, 1.0),
         (ds.y, 1.0), (ds.z, 1.0),
         (jnp.full((TILE,), jtk.FLT_MAX), 0.0),
         (jnp.ones((TILE,), jnp.float32), 0.0)], 8 * TILE)


def _jax_plan(jcp, ray_in):
    return jax.jit(lambda r: jtk._plan_visits(
        jcp, r, 8, TILE, True, True, "ray", 8))(ray_in)


def test_make_tris_and_rays_equal_bench_stream():
    """make_tris / make_rays equal benchmarks/bench_stream.py's bit for bit
    from the same generator state."""
    a, b = np.random.default_rng(s2.SEED), np.random.default_rng(s2.SEED)
    for x, y in zip(s2.make_tris(N_PRIMS, a),
                    bench_stream.make_tris(N_PRIMS, b)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    (tp, td), (jp, jd) = s2.make_rays(N_RAYS, a), bench_stream.make_rays(
        N_RAYS, b)
    for x, y in zip((*tp, *td), (*jp, *jd)):
        assert np.array_equal(_bits(x.numpy()), _bits(y))


@pytest.mark.parametrize("tile", TILES)
def test_one_tile_plan_equals_jax_tile_0(packs, tile):
    """The port plans the tile alone; the JAX script plans it padded to 8
    tiles. nvis, and below it the visit ids and entry bits, equal JAX's
    tile 0, and the JAX padding tiles plan nothing."""
    jcp, jp, jd, tcp, tp, td = packs
    visit, entry, nvis = _jax_plan(jcp, _jax_tile(jp, jd, tile))
    tv, te, tn = s2.tile_plan(tcp, *s2.tile_rays(tp, td, tile))
    nv = int(nvis[0, 0])
    assert nv > 0 and tv.shape == (1, tcp.num_clusters)
    assert int(tn[0]) == nv and not np.asarray(nvis)[1:].any()
    assert np.array_equal(tv[0, :nv].numpy(), np.asarray(visit)[0, :nv])
    assert np.array_equal(_bits(te[0, :nv].numpy()),
                          _bits(np.asarray(entry)[0, :nv]))


def _dma_replay(jcp, nvis, visit, packed):
    """The JAX script's DMA-replay kernel (benchmarks/diag_stream2.py:118,
    launched at :152), copied as it is, in interpret mode."""
    f8 = jtk._stream_rows(jcp.kind)
    nv = int(np.asarray(nvis)[0, 0])

    def kernel(nvis_r, visit_r, packed_r, out, buf, sem):
        def body(j, _):
            slot = jax.lax.rem(j, 2)

            @pl.when(j + 1 < nvis_r[0, 0])
            def _():
                c2 = visit_r[0, j + 1]
                pltpu.make_async_copy(
                    packed_r.at[pl.ds(c2 * f8, f8), :],
                    buf.at[pl.ds((1 - slot) * f8, f8), :],
                    sem.at[1 - slot],
                ).start()

            @pl.when(j == 0)
            def _():
                c0 = visit_r[0, 0]
                pltpu.make_async_copy(
                    packed_r.at[pl.ds(c0 * f8, f8), :],
                    buf.at[pl.ds(0, f8), :],
                    sem.at[0],
                ).start()

            c = visit_r[0, j]
            pltpu.make_async_copy(
                packed_r.at[pl.ds(c * f8, f8), :],
                buf.at[pl.ds(slot * f8, f8), :],
                sem.at[slot],
            ).wait()
            out[pl.ds(j * f8, f8), :] = buf[pl.ds(slot * f8, f8), :]
            return 0

        jax.lax.fori_loop(0, nvis_r[0, 0], body, 0)

    nvp = -(-nv // 8) * 8
    return pl.pallas_call(
        kernel,
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((nvp * f8, jcp.cluster_size),
                                       jnp.float32),
        scratch_shapes=[
            pltpu.VMEM((2 * f8, jcp.cluster_size), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )(nvis[:1], visit[:1], packed)


@pytest.mark.parametrize("tile", TILES)
def test_stream_replay_plain_equals_jax_dma_replay(packs, tile):
    """stream_replay on the CPU (its plain version, an index gather of the
    packed table) against the JAX script's DMA-replay kernel in interpret
    mode: the same [ceil(nv / 8) * 8 * 16, K] table, every visit's 16 rows
    bit for bit; the rows of the visits past nv (unwritten by the JAX
    kernel) are zero in the port's. The dma stage finds no visit amiss."""
    jcp, jp, jd, tcp, tp, td = packs
    visit, _, nvis = _jax_plan(jcp, _jax_tile(jp, jd, tile))
    packed = jtk._tables_packed(jcp)
    want = np.asarray(_dma_replay(jcp, nvis, visit, packed))
    tv, _, tn = s2.tile_plan(tcp, *s2.tile_rays(tp, td, tile))
    got = ct.stream_replay(tcp, tv, tn, 0).numpy()
    nv, f8 = int(tn[0]), ct._stream_rows("triangle")
    assert got.shape == want.shape == (ct.replay_visits(nv) * f8, K)
    assert np.array_equal(_bits(got[:nv * f8]), _bits(want[:nv * f8]))
    assert not got[nv * f8:].any()
    assert np.array_equal(_bits(ct._tables_packed(tcp).numpy()),
                          _bits(np.asarray(packed)))
    result = s2.dma(tcp, tp, td, tile)
    assert result["nv"] == nv and result["bad"] == [] and \
        result["pad_nonzero"] == 0


def _jax_prefix(jcp, ray_in, plan, m):
    """The streamed walk of the JAX package (``_stream_kernels(shadow=
    False)``) over the 8-tile grid with nvis clamped to m, in interpret
    mode, as the script's run_prefix launches it: (tfar, packed ids) of
    tile 0's rays."""
    visit, entry, nvis = plan
    rp, c, f8 = 8 * TILE, jcp.num_clusters, jtk._stream_rows(jcp.kind)
    col = pl.BlockSpec((TILE, 1), lambda i: (i, 0), memory_space=pltpu.VMEM)
    smem_row = lambda w: pl.BlockSpec((8, w), lambda i: (i // 8, 0),
                                      memory_space=pltpu.SMEM)
    root_spec = pl.BlockSpec((1, 8), lambda i: (0, 0),
                             memory_space=pltpu.SMEM)
    tfar, prim = pl.pallas_call(
        jtk._stream_kernels(jcp.kind, jcp.cluster_size, shadow=False),
        grid=(8,),
        in_specs=[smem_row(1), smem_row(c), smem_row(c), root_spec]
        + [col] * 8 + [pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[col, col],
        out_shape=[jax.ShapeDtypeStruct((rp, 1), jnp.float32),
                   jax.ShapeDtypeStruct((rp, 1), jnp.int32)],
        scratch_shapes=[
            pltpu.SMEM((1, 1), jnp.float32),
            pltpu.VMEM((2 * f8, jcp.cluster_size), jnp.float32),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )(jnp.minimum(nvis, m), visit, entry, jtk._root_row(jcp), *ray_in,
      jtk._tables_packed(jcp))
    return np.asarray(tfar)[:TILE, 0], np.asarray(prim)[:TILE, 0]


def test_prefix_walk_equals_jax_stream_kernel(packs):
    """The prefix walk (walk_closest(stream=True) with nvis clamped to m:
    the plain streamed walk on the CPU) at m = 1, nv / 2 and nv against the
    JAX package's streamed walk kernel with nvis clamped, in interpret
    mode: the bits of tfar and the ids of every ray of the tile. The plain
    replay of the trace stage agrees at each m."""
    jcp, jp, jd, tcp, tp, td = packs
    tile = TILES[1]
    ray_in = _jax_tile(jp, jd, tile)
    plan = _jax_plan(jcp, ray_in)
    ps, ds = s2.tile_rays(tp, td, tile)
    tplan = s2.tile_plan(tcp, ps, ds)
    nv = int(tplan[2][0])
    exp_t, exp_id = s2.replay_plain(tcp, tplan[0][0, :nv].numpy(), nv, ps, ds)
    for m in (1, nv // 2, nv):
        want_t, want_id = _jax_prefix(jcp, ray_in, plan, m)
        got_t, got_id = s2.prefix_walk(tcp, ps, ds, tplan, m)
        assert np.array_equal(_bits(got_t.numpy()), _bits(want_t))
        assert np.array_equal(got_id.numpy(), want_id)
        assert np.array_equal(_bits(exp_t[m - 1].numpy()), _bits(want_t))
        assert np.array_equal(exp_id[m - 1].numpy(), want_id)
    assert (got_id >= 0).sum() > 0


def test_trace_finds_no_divergence(packs):
    """The trace stage on a tile: the prefix walk equals the plain replay on
    every ray over the whole list (no diverging visit)."""
    *_, tcp, tp, td = packs
    result = s2.trace(tcp, tp, td, TILES[1])
    assert result["nv"] > 0 and result["first"] is None


def test_trace2_variants_agree(packs):
    """trace2's four variants (plan and packed table made in the call or
    beforehand and copied) give the same tfar bits and ids at each prefix,
    equal to the plain prefix walk."""
    *_, tcp, tp, td = packs
    tile = TILES[1]
    ps, ds = s2.tile_rays(tp, td, tile)
    plan = s2.tile_plan(tcp, ps, ds)
    runs = {v: s2.trace2(tcp, tp, td, tile, v) for v in s2.VARIANTS}
    for m in s2.TRACE2_PREFIXES:
        want_t, want_id = s2.prefix_walk_plain(tcp, ps, ds, plan, m)
        for v, out in runs.items():
            assert torch.equal(out[m][0].view(torch.int32),
                               want_t.view(torch.int32)), v
            assert torch.equal(out[m][1], want_id), v


def test_cli_refuses_no_cp(capsys):
    """The JAX script's 'no-cp' variant lifts a Mosaic VMEM limit that has
    no counterpart on the card: the CLI refuses it, before any work."""
    with pytest.raises(SystemExit) as e:
        s2.main(["--stage", "trace2", "--variant", "no-cp", "--device",
                 "cpu"])
    assert e.value.code == 2
    assert "no counterpart on the card" in capsys.readouterr().err


def test_cli_without_a_card_raises(monkeypatch):
    """Without a card and without --device cpu the entry raises; nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        s2.main(["--stage", "dma", "--tile", "0"])


def test_stream_replay_refuses_what_it_cannot_launch(packs):
    """The replay's launch form takes CUDA tensors only: on the CPU it
    raises (the wrapper takes the plain version there)."""
    *_, tcp, tp, td = packs
    visit, _, nvis = s2.tile_plan(tcp, *s2.tile_rays(tp, td, 0))
    with pytest.raises(ValueError, match="cuda"):
        ct.replay_launch(tcp, visit, nvis, 0, 8)


@pytest.mark.parametrize("sms", (1, 4, 132))
def test_replay_slices_cover_the_list(sms):
    """The replay's partition (replay_blocks, replay_slices) for lists of 0
    to 300 visits: the blocks' slices take every visit once, in order, none
    past nv, each at least two visits where nv has two, at most
    REPLAY_BLOCKS_PER_SM blocks an SM, block b's slice from visit 2b on
    wherever nv // 2 blocks fit; and on a grid sized from any output
    of n_out >= nv visits, the blocks the kernel lets own visits,
    min(grid, max(1, nv // 2)), are the partition's."""
    for nv in range(301):
        slices = ct.replay_slices(nv, sms)
        assert len(slices) == ct.replay_blocks(nv, sms)
        assert len(slices) <= ct.REPLAY_BLOCKS_PER_SM * sms
        assert [j for a, b in slices for j in range(a, b)] == list(range(nv))
        assert all(a <= b <= nv for a, b in slices)
        if nv >= 2:
            assert min(b - a for a, b in slices) >= 2, (nv, slices)
        if nv // 2 <= ct.REPLAY_BLOCKS_PER_SM * sms:  # the L1 prefetch
            assert [a for a, _ in slices] == [2 * b for b in
                                              range(len(slices))]
        for n_out in {nv, ct.replay_visits(nv), nv + 9, 64 + nv}:
            grid = ct.replay_blocks(n_out, sms)
            assert min(grid, max(1, nv // 2)) == len(slices)


@pytest.mark.cuda
def test_stream_replay_and_prefix_walk_match_plain_on_card(packs):
    """On a card: the stream_replay kernel equals its plain version bit for
    bit on two tiles (one launch each, and on forced partitions), and the
    prefix walk equals the plain prefix walk at m = 1, nv / 2 and nv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    *_, tcp, tp, td = packs
    cp = tcp.to("cuda")
    p, d = (type(tp)(*(a.cuda() for a in v)) for v in (tp, td))
    for tile in TILES:
        ps, ds = s2.tile_rays(p, d, tile)
        visit, entry, nvis = plan = s2.tile_plan(cp, ps, ds)
        before = ct.REPLAY.launches
        got = ct.stream_replay(cp, visit, nvis, 0)
        assert ct.REPLAY.launches == before + 1
        want = ct.stream_replay_plain(cp, visit, nvis, 0)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        nv = int(nvis[0])
        # forced partitions: long slices on the grid of a one-SM card, and
        # a grid larger than the list
        rows = want.shape[0]
        for n_out, sms in ((ct.replay_visits(nv), 1), (64 + nv, None)):
            got = ct.replay_launch(cp, visit, nvis, 0, n_out, sms=sms)
            assert torch.equal(got[:rows].view(torch.int32),
                               want.view(torch.int32))
            assert not bool(got[rows:].any())
        for m in (1, nv // 2, nv):
            kt, kid = s2.prefix_walk(cp, ps, ds, plan, m)
            pt, pid = s2.prefix_walk_plain(cp, ps, ds, plan, m)
            assert torch.equal(kid, pid)
            assert torch.equal(kt.view(torch.int32), pt.view(torch.int32))
