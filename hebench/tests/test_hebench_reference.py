"""The plain reference against the port on the CPU at tiny sizes: it
accepts the port's outputs and rejects broken ones; its NTT product, its
moduli and its forward pass agree with plain arithmetic and the port."""

import numpy as np
import pytest
import torch

from _tiny import CKKS, make_root
from hebench import harness
from hebench.reference import ckks, cnn, primes


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def test_negacyclic_product_matches_schoolbook():
    q = primes.ntt_primes(4, 20.0, 2)
    rng = np.random.default_rng(1)
    a = rng.integers(0, min(q), (2, 16))
    b = rng.integers(-1, 2, 16)
    ntt = ckks.NegacyclicNTT(q, 4, torch.device("cpu"))
    ta = torch.as_tensor(a)
    got = ntt.inverse(ntt.forward(ta) * ntt.forward(
        torch.as_tensor(b).expand(2, 16)) % ntt.q)
    for l, ql in enumerate(q):
        want = np.zeros(16, dtype=object)
        for i in range(16):
            for j in range(16):
                k, sgn = (i + j) % 16, (-1 if i + j >= 16 else 1)
                want[k] += sgn * int(a[l, i]) * int(b[j])
        assert [int(v) % ql for v in want] == got[l].tolist()


def test_moduli_match_the_port():
    from mkhe_tpu_torch.mkckks import params as port
    for kw in port._PRESETS.values():
        want = port.select_moduli(kw["logn"], kw["q0_bits"],
                                  kw["level_bits"], kw["levels"],
                                  p_bits=kw["p_bits"], p_count=kw["p_count"])
        assert primes.ckks_moduli(**kw) == want


def test_forward_pass_matches_the_port():
    from mkhe_tpu_torch.models import cnn as port
    w = port.load_weights()
    img = np.random.default_rng(3).uniform(0, 1, (28, 28))
    lo = {k: getattr(port.REF, k) for k in ("image", "num_kernels", "ksize",
                                            "fc_units", "classes")}
    assert np.allclose(cnn.plain_forward(img, *w, lo),
                       port.plain_forward(img, *w), rtol=0, atol=1e-9)


@pytest.mark.parametrize("cell", ["tiny.mulrelin", "tiny.ptmul"])
def test_accepts_the_port(root, cell):
    r = harness.run_cell(cell, 2 ** 32 + 11, 0.3, False, "cpu", root)
    assert r["correct"], r["checks"]
    assert r["checks"]["not_small"]["value"] == 0


def test_small_values_flag_a_perturbed_limb():
    q, _ = primes.ckks_moduli(**CKKS["params"])
    vals = torch.tensor([5, -7, 2 ** 40, -(2 ** 50)] * 256, dtype=torch.int64)
    x = torch.stack([vals % ql for ql in q])
    got, bad = ckks.small_values(x, q)
    assert bad == 0 and torch.equal(got, vals.double())
    x[len(q) // 2, 3] = (x[len(q) // 2, 3] + 1) % q[len(q) // 2]
    assert ckks.small_values(x, q)[1] == 1
