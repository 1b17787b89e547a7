"""The port's native exact-CRT decode (mkhe_tpu_torch.native) against the
JAX package's (mkhe_tpu.native) and the plain python CRT (utils.crt):

  - crt_native.cpp is a byte-identical copy of the JAX package's;
  - crt_center_double, bfv_decode_scale and crt_max_bits equal mkhe_tpu's
    exactly at L = 1, 2, 3, 14 and 28, and utils.crt within
    tests/test_native_crt.py's tolerances (<= 1e-15 relative for the
    doubles, exact for the rest), edge values included;
  - both schemes' decode equal mkhe_tpu's bit for bit (CKKS by the
    2-limb path, the exact path and the 2-limb path's fallback; BFV at
    several levels);
  - the g++ build raises on a source that does not compile and rebuilds
    when the source's hash changes.
"""

import shutil

import numpy as np
import pytest

from mkhe_tpu import native as jnative
from mkhe_tpu.mkbfv import encoder as jbenc
from mkhe_tpu.mkbfv import params as jbparams
from mkhe_tpu.mkckks import encoder as jcenc
from mkhe_tpu.ops.primes import ntt_primes
from mkhe_tpu_torch import convert
from mkhe_tpu_torch import native
from mkhe_tpu_torch.mkbfv import encoder as tbenc
from mkhe_tpu_torch.mkckks import encoder as tcenc
from mkhe_tpu_torch.utils import crt

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no C++ toolchain")

LS = [1, 2, 3, 14, 28]


def _limbs(L, n=512, seed=11):
    rng = np.random.default_rng(seed + L)
    moduli = ntt_primes(10, 28.9, L)
    q = np.array(moduli, np.uint64)
    x = (rng.integers(0, 2 ** 63, (L, n), np.uint64)
         % q[:, None]).astype(np.uint32)
    return moduli, x


def test_source_is_the_jax_packages():
    from pathlib import Path
    jax_src = Path(jnative.__file__).resolve().parent / "crt_native.cpp"
    assert native.SRC.read_bytes() == jax_src.read_bytes()


@pytest.mark.parametrize("L", LS)
def test_equal_to_jax_native(L):
    moduli, x = _limbs(L)
    got = native.crt_center_double(x, moduli)
    want = jnative.crt_center_double(x, moduli)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    for t in (2, 65537, (1 << 31) - 1):
        np.testing.assert_array_equal(native.bfv_decode_scale(x, moduli, t),
                                      jnative.bfv_decode_scale(x, moduli, t))
    assert native.crt_max_bits(x, moduli) == jnative.crt_max_bits(x, moduli)


@pytest.mark.parametrize("L", LS)
def test_against_python_crt(L):
    moduli, x = _limbs(L)
    centered = crt.crt_center(x, moduli)
    np.testing.assert_allclose(native.crt_center_double(x, moduli),
                               np.array([float(v) for v in centered]),
                               rtol=1e-15)
    Q = int(np.prod([int(m) for m in moduli], dtype=object))
    c = crt.crt_reconstruct(x, moduli)
    t = 65537
    want = np.array([(t * int(v) + Q // 2) // Q % t for v in c], np.uint32)
    np.testing.assert_array_equal(native.bfv_decode_scale(x, moduli, t),
                                  want)
    assert native.crt_max_bits(x, moduli) == crt.log2_max_abs(centered)


def test_edge_values():
    """All-zero and Q - 1 (= -1 centred) coefficients."""
    moduli = ntt_primes(10, 28.9, 4)
    zeros = np.zeros((4, 8), np.uint32)
    minus1 = np.stack([np.full(8, m - 1, np.uint32) for m in moduli])
    np.testing.assert_array_equal(native.crt_center_double(zeros, moduli),
                                  np.zeros(8))
    np.testing.assert_array_equal(native.crt_center_double(minus1, moduli),
                                  np.full(8, -1.0))
    assert native.crt_max_bits(minus1, moduli) == 1
    assert native.crt_max_bits(zeros, moduli) == 0


def test_bad_arguments_raise():
    moduli, x = _limbs(3)
    with pytest.raises(ValueError, match="limbs"):
        native.crt_center_double(x[:2], moduli)
    with pytest.raises(ValueError, match="1 < t < 2"):
        native.bfv_decode_scale(x, moduli, 1 << 32)


# ----------------------------------------------------------------------------
# The decoders
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("L,exact,big", [(2, None, False), (3, None, False),
                                         (6, False, False), (6, True, False),
                                         (6, None, True), (1, None, False)])
def test_ckks_decode_equals_jax(L, exact, big):
    """The 2-limb path (L > 2), the exact path (L <= 2 or exact=True) and
    the 2-limb path's fallback to the exact CRT (values above q0 q1 / 2)."""
    logn = 10
    moduli = ntt_primes(logn, 28.9, L)
    rng = np.random.default_rng(40 + L)
    bound = 2 ** 60 if big else 2 ** 40
    vals = rng.integers(-bound, bound, 1 << logn).astype(object)
    poly = crt.to_rns(vals, moduli)
    kw = dict(logslots=logn - 2, exact=exact)
    got = tcenc.decode(poly, 2.0 ** 30, moduli, logn, **kw)
    want = jcenc.decode(poly, 2.0 ** 30, moduli, logn, **kw)
    np.testing.assert_array_equal(got.view(np.float64),
                                  np.asarray(want).view(np.float64))


@pytest.fixture(scope="module")
def bfv_params():
    logn = 9
    q = ntt_primes(logn, 26.5, 5)
    qmul = ntt_primes(logn, 26.5, 5, skip=5)
    p = ntt_primes(logn, 28.4, 2)
    jp = jbparams.new_parameters(logn, q, qmul, p, t=65537)
    rl = jp.rlwe
    tp = convert.bfv_parameters(
        convert.rlwe_parameters(logn, rl.q_moduli, rl.p_moduli, rl.gamma,
                                rl.sigma, {}, device="cpu"),
        jp.qmul_moduli, jp.t)
    return jp, tp


@pytest.mark.parametrize("L", [5, 3, 1])
def test_bfv_decode_equals_jax(bfv_params, L):
    jp, tp = bfv_params
    moduli = jp.rlwe.q_moduli[:L]
    rng = np.random.default_rng(70 + L)
    q = np.array(moduli, np.uint64)
    poly = (rng.integers(0, 2 ** 63, (L, jp.n), np.uint64)
            % q[:, None]).astype(np.uint32)
    np.testing.assert_array_equal(tbenc.decode(tp, poly),
                                  np.asarray(jbenc.decode(jp, poly)))


# ----------------------------------------------------------------------------
# The build
# ----------------------------------------------------------------------------

def test_failed_build_raises(tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build"):
        native.gxx_build(bad, tmp_path / "libbad.so", ["-shared", "-fPIC"])
    assert not (tmp_path / "libbad.so").exists()


def test_rebuilds_on_source_change(tmp_path):
    src = tmp_path / "f.cpp"
    out = tmp_path / "libf.so"
    src.write_text('extern "C" int f() { return 1; }\n')
    native.gxx_build(src, out, ["-shared", "-fPIC"])
    first = (tmp_path / "libf.so.sha256").read_text()
    src.write_text('extern "C" int f() { return 2; }\n')
    native.gxx_build(src, out, ["-shared", "-fPIC"])
    assert (tmp_path / "libf.so.sha256").read_text() != first
