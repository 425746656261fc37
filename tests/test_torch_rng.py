"""Bit parity of the PyTorch port's u32 RNG and bit utilities with the JAX
package's ``core/rng.py`` and ``core/bitmanip.py``.

The port holds u32 values in int64 tensors (PyTorch's uint32 lacks +, >> and
minimum); every function must return the JAX package's bits exactly, on the
same seeded inputs."""
import numpy as np
import pytest
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
