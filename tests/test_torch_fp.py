"""The PyTorch port's float32 multiply-add (``core/fp.py::fma``) against
jitted JAX ``a*b + c``, which XLA on the CPU contracts into one
fused multiply-add, and against the exact rounding of ``fractions.Fraction``.

Tolerance: equal bits (NaN lanes: both NaN). The constructed triples are
ones where rounding the float64 sum to float32 rounds twice; the random ones
have exponents from -30 to 30. The fma kernel of the card
(``ops/kernels/fma.py``) is held to the plain form by the test marked
``cuda`` and by ``chip_smoke.py``; here its layout of broadcast operands is
checked by replaying that layout with ``as_strided``.
"""
from fractions import Fraction

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cpu_raytracing_experiments_tpu_torch.core import fp
from cpu_raytracing_experiments_tpu_torch.ops.kernels import fma as kfma

torch.set_num_threads(1)

_jax_fma = jax.jit(lambda a, b, c: a * b + c)


def _constructed(k=np.arange(2800, 2960)):
    """a = 1 + k 2^-23, b = 2^-24 (1 - (k - 1) 2^-23), c = 1: a*b + c lies
    just off a float32 midpoint, and its float64 rounding lands on it."""
    a = (1.0 + k * 2.0 ** -23).astype(np.float32)
    b = (2.0 ** -24 * (1.0 - (k - 1) * 2.0 ** -23)).astype(np.float32)
    return a, b, np.ones_like(a)


def _wide(g, n):
    """Random float32 of either sign with exponents from -30 to 30."""
    return (g.uniform(1.0, 2.0, n) * 2.0 ** g.integers(-30, 31, n)
            * g.choice([-1.0, 1.0], n)).astype(np.float32)


def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational x, ties to even, with subnormals and
    overflow to inf."""
    if x == 0:
        return np.float32(0.0)
    mag = abs(x)
    e = mag.numerator.bit_length() - mag.denominator.bit_length()
    if Fraction(2) ** e > mag:
        e -= 1  # now 2^e <= mag < 2^(e+1)
    ulp = Fraction(2) ** (max(e, -126) - 23)
    q, r = divmod(mag, ulp)
    if r > ulp / 2 or (r == ulp / 2 and q % 2 == 1):
        q += 1
    v = q * ulp
    if v >= Fraction(2) ** 128:
        return np.float32(np.inf if x > 0 else -np.inf)
    return np.float32(float(v) if x > 0 else -float(v))


def _exact(a, b, c):
    """The correctly rounded a*b + c of finite float32 arrays; an exact zero
    takes IEEE's sign, which float64 arithmetic gives exactly."""
    out = []
    for x, y, z in zip(a, b, c):
        v = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        out.append(_round_f32(v) if v != 0
                   else np.float32(float(x) * float(y) + float(z)))
    return np.array(out, np.float32)


def _fma(a, b, c):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return fp.fma(t(a), t(b), t(c)).numpy()


def _same(x, y):
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    nan = np.isnan(x) & np.isnan(y)
    return bool(np.all(nan | (x.view(np.int32) == y.view(np.int32))))


def test_constructed_double_rounding_triples():
    """On the triples where a float64 sum rounds twice, fp.fma equals
    jitted JAX and the exact rounding; the float64 sum rounded to float32
    differs from both on some of them."""
    a, b, c = _constructed()
    got = _fma(a, b, c)
    want = np.asarray(_jax_fma(a, b, c))
    assert _same(want, _exact(a, b, c))
    assert _same(got, want)
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).sum() >= 20  # the fault the plain form repairs
    k = 2875
    i = k - 2800
    assert got[i] == np.float32(1.0 + 2.0 ** -23)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_wide_triples_match_jax(seed):
    """10^6 random wide-exponent triples (500,000 per seed): equal to
    jitted JAX, and the first 2,000 to the exact rounding."""
    g = np.random.default_rng(seed)
    n = 500_000
    a, b, c = _wide(g, n), _wide(g, n), _wide(g, n)
    got = _fma(a, b, c)
    assert _same(got, np.asarray(_jax_fma(a, b, c)))
    assert _same(got[:2000], _exact(a[:2000], b[:2000], c[:2000]))


def test_specials_nan_inf_zero_subnormal():
    """NaN and inf propagate, signed zeros come out as IEEE fma gives them,
    and float32-subnormal results round correctly: every finite row equals
    the exact rounding, and every row whose result is not subnormal equals
    jitted JAX (XLA on the CPU flushes subnormal results to zero)."""
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    tiny = np.float32(2.0 ** -75)
    rows = [
        (nan, 1, 1), (1, nan, 1), (1, 1, nan), (inf, 1, 1), (inf, 0, 1),
        (inf, 1, -inf), (1e30, 1e30, -inf), (1e30, 1e30, 0),
        (-1e30, 1e30, 1), (3.0, 4.0, inf),
        # signed zeros: (-0)*1 + 0 = +0, (-0)*1 + (-0) = -0, 0*(-1) + (-0)
        # = -0, 2*3 - 6 = +0, -2*3 + 6 = +0
        (-0.0, 1, 0.0), (-0.0, 1, -0.0), (0.0, -1, -0.0), (2, 3, -6),
        (-2, 3, 6),
        # subnormal results and near-ties in the subnormal range
        (tiny, tiny, 0), (tiny, np.float32(tiny * 1.5), 0),
        (tiny, np.float32(tiny * 1.25), np.float32(2.0 ** -149)),
        (np.float32(2.0 ** -70), np.float32(2.0 ** -70 * 1.75),
         np.float32(-2.0 ** -140)),
        (np.float32(1.5 * 2.0 ** -63), np.float32(1.5 * 2.0 ** -63),
         np.float32(-2.0 ** -126)),
        (np.float32(2.0 ** -100), np.float32(2.0 ** -50),
         np.float32(2.0 ** -149)),
    ]
    a, b, c = (np.array(col, np.float32) for col in zip(*rows))
    got = _fma(a, b, c)
    want = np.asarray(_jax_fma(a, b, c))
    normal = ~((np.abs(got) < np.float32(2.0 ** -126)) & (got != 0))
    assert _same(got[normal], want[normal])
    finite = np.isfinite(a) & np.isfinite(b) & np.isfinite(c)
    assert _same(got[finite], _exact(a[finite], b[finite], c[finite]))
    assert [bool(np.signbit(v)) for v in got[10:15]] == [False, True, True,
                                                         False, False]
    sub = np.abs(got[finite]) < np.float32(2.0 ** -126)
    assert (sub & (got[finite] != 0)).sum() >= 3


@pytest.mark.parametrize("shape_a,shape_b,shape_c", [
    ((6, 1), (1, 5), None), ((6, 5), None, (1, 5)), ((4, 1, 3), (1, 2, 3),
                                                    (4, 2, 1)),
    ((7,), None, None)])
def test_broadcasting_and_python_floats(shape_a, shape_b, shape_c):
    """Broadcast tensors and Python-float b or c (taken as float32, as a
    weakly typed scalar is in JAX): equal to jitted JAX. The product a*b has
    the output's shape in every case: XLA computes a product of a smaller
    shape before broadcasting it, and does not contract it then."""
    g = np.random.default_rng(5)
    a = _wide(g, int(np.prod(shape_a))).reshape(shape_a)
    b = (_wide(g, int(np.prod(shape_b))).reshape(shape_b)
         if shape_b is not None else 0.1)
    c = (_wide(g, int(np.prod(shape_c))).reshape(shape_c)
         if shape_c is not None else -1.3)
    t = lambda x: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    got = fp.fma(t(a), t(b), t(c))
    want = _jax_fma(jnp.asarray(a), b if shape_b is None else jnp.asarray(b),
                    c if shape_c is None else jnp.asarray(c))
    assert tuple(got.shape) == tuple(want.shape)
    assert _same(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["contiguous", "broadcast", "strided",
                                  "size_one"])
def test_kernel_layout_replays_broadcasting(case):
    """The fma kernel's operand layout (``ops/kernels/fma.py::_layout``):
    each operand read through the merged sizes and strides, as the kernel
    reads it, gives the operand broadcast to the output's shape."""
    base = torch.arange(120, dtype=torch.float32)
    operands = {
        "contiguous": (base.reshape(4, 30), base.reshape(4, 30) + 1, 2.0),
        "broadcast": (base[:6].reshape(6, 1), base[:5].reshape(1, 5),
                      base[:30].reshape(6, 5)),
        "strided": (base.reshape(10, 12)[:, ::3],
                    base.reshape(12, 10).t()[:, ::3], 0.5),
        "size_one": (base[:12].reshape(3, 1, 4), base[:4].reshape(1, 1, 4),
                     base[:3].reshape(3, 1, 1)),
    }[case]
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    shape = torch.broadcast_shapes(*(x.shape for x in tensors))
    sizes, strides = kfma._layout(shape, operands)
    assert len(sizes) <= kfma.MAX_DIMS
    assert int(np.prod(sizes)) == int(np.prod(shape))
    for x, st in zip(operands, strides):
        if not isinstance(x, torch.Tensor):
            assert all(v == 0 for v in st)
            continue
        replay = torch.as_strided(x, sizes, st, x.storage_offset())
        assert torch.equal(replay.reshape(shape), x.expand(shape))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches for CUDA tensors only; fp.fma takes the
    plain form for a CPU tensor."""
    with pytest.raises(ValueError, match="cpu"):
        kfma.fma(torch.ones(3), 2.0, 1.0)
    assert torch.equal(fp.fma(torch.ones(3), 2.0, 1.0), torch.full((3,), 3.0))


@pytest.mark.cuda
def test_fma_kernel_matches_plain_on_card():
    """The fma kernel on a CUDA card against the plain round-to-odd form:
    equal bits on wide random triples, the constructed ones, specials and
    broadcast operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    g = np.random.default_rng(9)
    n = 1 << 20
    cols = [np.concatenate([_wide(g, n), x]) for x in _constructed()]
    a, b, c = (torch.from_numpy(x).cuda() for x in cols)
    launches = kfma.FMA.launches
    got = fp.fma(a, b, c)
    assert kfma.FMA.launches == launches + 1
    assert _same(got.cpu().numpy(), fp.fma_plain(a, b, c).cpu().numpy())
    x, y = a[:600].reshape(20, 30), b[:30].reshape(1, 30)
    assert _same(fp.fma(x, y, 0.5).cpu().numpy(),
                 fp.fma_plain(x, y, 0.5).cpu().numpy())
