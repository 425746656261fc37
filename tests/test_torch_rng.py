"""Bit parity of the PyTorch port's u32 RNG and bit utilities with the JAX
package's ``core/rng.py`` and ``core/bitmanip.py``.

The port holds u32 values in int64 tensors (PyTorch's uint32 lacks +, >> and
minimum); every function must return the JAX package's bits exactly, on the
same seeded inputs."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu.core import bitmanip as jbm
from cpu_raytracing_experiments_tpu.core import rng as jrng
from cpu_raytracing_experiments_tpu_torch.core import bitmanip as tbm
from cpu_raytracing_experiments_tpu_torch.core import rng as trng

# The suite runs in several worker processes at once: one intra-op thread
# each, or the workers' thread pools fight over the cores.
torch.set_num_threads(1)

EDGES = [0, 1, 2, 3, 12345, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFE,
         0xFFFFFFFF, 747796405, 2891336453]


def _u32(seed, n=4096):
    g = np.random.default_rng(seed)
    return np.concatenate([np.asarray(EDGES, np.uint32),
                           g.integers(0, 2 ** 32, n, dtype=np.uint32)])


def _same(jax_out, torch_out):
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


UNARY = {
    "pcg_state_transition": (jrng.pcg_state_transition,
                             trng.pcg_state_transition),
    "pcg_output": (jrng.pcg_output, trng.pcg_output),
    "hash_u32": (jrng.hash_u32, trng.hash_u32),
    "bitreverse32": (jrng.bitreverse32, trng.bitreverse32),
    "make_unit_float": (jrng.make_unit_float, trng.make_unit_float),
    "popcount32": (jbm.popcount32, tbm.popcount32),
    "round_up_pow2": (jbm.round_up_pow2, tbm.round_up_pow2),
    "morton_decode2d_x": (lambda a: jbm.morton_decode2d(a)[0],
                          lambda a: tbm.morton_decode2d(a)[0]),
    "morton_decode2d_y": (lambda a: jbm.morton_decode2d(a)[1],
                          lambda a: tbm.morton_decode2d(a)[1]),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_bit_parity(name):
    """core/rng.py and core/bitmanip.py unary functions, bit for bit."""
    jf, tf = UNARY[name]
    x = _u32(hash(name) % 1000)
    _same(jf(jnp.asarray(x)), tf(torch.from_numpy(x.astype(np.int64))))


def test_hash_2d_parity():
    """core/rng.py::hash_2d on tensor x tensor and scalar x tensor."""
    x, y = _u32(1), _u32(2)
    tx, ty = torch.from_numpy(x.astype(np.int64)), torch.from_numpy(
        y.astype(np.int64))
    _same(jrng.hash_2d(jnp.asarray(x), jnp.asarray(y)), trng.hash_2d(tx, ty))
    for acc in (1, 7, 0xFFFFFFFF):
        _same(jrng.hash_2d(jnp.uint32(acc), jnp.asarray(y)),
              trng.hash_2d(acc, ty))


def test_morton_encode_parity():
    x, y = _u32(3) & 0xFFFF, _u32(4) & 0xFFFF
    _same(jbm.morton_encode2d(jnp.asarray(x), jnp.asarray(y)),
          tbm.morton_encode2d(torch.from_numpy(x.astype(np.int64)),
                              torch.from_numpy(y.astype(np.int64))))


def test_float_exponent_parity():
    g = np.random.default_rng(5)
    f = np.concatenate([g.normal(size=1000) * 10.0 ** g.integers(-30, 30, 1000),
                        [0.0, -0.0, np.inf, -np.inf]]).astype(np.float32)
    _same(jbm.float_exponent(jnp.asarray(f)),
          tbm.float_exponent(torch.from_numpy(f)))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_draws_parity(n):
    """core/rng.py::draws: the final state and every unit float."""
    s = _u32(6)
    js, jouts = jrng.draws(jnp.asarray(s), n)
    ts, touts = trng.draws(torch.from_numpy(s.astype(np.int64)), n)
    _same(js, ts)
    for a, b in zip(jouts, touts):
        _same(a, b)


@pytest.mark.parametrize("range_", [1, 3, 9, 255, 1000])
def test_rand_bounded_int_parity(range_):
    """core/rng.py::rand_bounded_int (Random.hpp:31-34)."""
    s = _u32(7)
    js, jv = jrng.rand_bounded_int(jnp.asarray(s), range_)
    ts, tv = trng.rand_bounded_int(torch.from_numpy(s.astype(np.int64)),
                                   range_)
    _same(js, ts)
    _same(jv, tv)
    assert int(tv.max()) < range_


# ---------------------------------------------------------------------------
# core/rng.py::site_draws (its plain version, which the CPU takes)
# ---------------------------------------------------------------------------
def _jax_site(acc, seeds, offset, n, scramble):
    """A site composed of the JAX package's functions: the state of
    hash_2d(acc, seeds + offset), hash_u32 under `scramble`, then `n`
    draws: (final state, [n] draws)."""
    state = jrng.hash_2d(acc, seeds + offset)
    if scramble:
        state = jrng.hash_u32(state)
    return jrng.draws(state, n)


def _site_operands(acc_kind, offset_kind):
    """(seeds, accumulation, offset) as JAX and as port operands: the
    EDGES and random u32 seeds; an accumulation of one value or one a lane;
    an offset of one value or an int32 one a lane (the pool's bounces)."""
    seeds = _u32(11)
    g = np.random.default_rng(12)
    acc = _u32(13) if acc_kind == "lane" else np.uint32(0xFFFFFFFE)
    if offset_kind == "lane":
        offset = g.integers(0, 2 ** 31, seeds.shape[0]).astype(np.int32)
        offset[:4] = [0, 1, 15, 2 ** 31 - 1]
        t_off = torch.from_numpy(offset)
        j_off = jnp.asarray(offset.astype(np.uint32))
    else:
        offset = t_off = 13
        j_off = jnp.uint32(offset)
    t_acc = (torch.from_numpy(acc.astype(np.int64)) if acc_kind == "lane"
             else int(acc))
    return ((jnp.asarray(seeds), jnp.asarray(acc), j_off),
            (torch.from_numpy(seeds.astype(np.int64)), t_acc, t_off))


@pytest.mark.parametrize("scramble", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("offset_kind", ["int", "lane"])
@pytest.mark.parametrize("acc_kind", ["scalar", "lane"])
def test_site_draws_parity(acc_kind, offset_kind, n, scramble):
    """site_draws on the CPU: every row, and the state under want_state,
    bit for bit the JAX package's hash_2d / hash_u32 / draws."""
    (js, ja, jo), (ts, ta, to) = _site_operands(acc_kind, offset_kind)
    want_state, want = jax.jit(_jax_site, static_argnums=(3, 4))(
        ja, js, jo, n, scramble)
    rows = trng.site_draws(ta, ts, to, n, scramble)
    assert rows.shape == (n, ts.shape[0]) and rows.dtype == torch.float32
    rows2, state = trng.site_draws(ta, ts, to, n, scramble, want_state=True)
    _same(want_state, state)
    for k in range(n):
        _same(want[k], rows[k])
        _same(want[k], rows2[k])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("acc_kind", ["scalar", "lane"])
def test_site_draws_jitter_parity(acc_kind, n):
    """site_draws(jitter=True) on the CPU: rows 0 and 1 the stratified
    camera jitter of the JAX renderer's generate_camera_rays (van der
    Corput, golden ratio, rotated by the hashed seed), the later rows the
    site's draws 2 and 3, bit for bit."""
    (js, ja, _), (ts, ta, _) = _site_operands(acc_kind, "int")

    def jax_jitter(acc, seeds):
        vdc = jrng.make_unit_float(jrng.bitreverse32(acc))
        gr = jnp.mod(acc.astype(jnp.float32)
                     * jnp.float32(0.6180339887498949), 1.0)
        ox = jrng.make_unit_float(jrng.hash_u32(seeds))
        oy = jrng.make_unit_float(
            jrng.hash_u32(seeds ^ jnp.uint32(0x9E3779B9)))
        return jnp.mod(vdc + ox, 1.0), jnp.mod(gr + oy, 1.0)

    jx, jy = jax.jit(jax_jitter)(ja * jnp.ones_like(js), js)
    _, jd = jax.jit(_jax_site, static_argnums=(3, 4))(ja, js, jnp.uint32(0),
                                                      n, False)
    rows = trng.site_draws(ta, ts, 0, n, False, jitter=True)
    _same(jx, rows[0])
    _same(jy, rows[1])
    for k in range(2, n):
        _same(jd[k], rows[k])
    tx, ty = trng.stratified_jitter(ta, ts)
    assert torch.equal(tx, rows[0]) and torch.equal(ty, rows[1])
