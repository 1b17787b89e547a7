"""The CUDA NTT kernels (mkhe_tpu_torch/csrc/ntt.cu) against their plain
PyTorch versions on the card, bit for bit. Needs an NVIDIA GPU and nvcc;
without a card every test skips. This file imports no JAX, so it also runs
on a machine without it:

    python -m pytest tests/test_torch_cuda.py -q -o addopts="" --noconftest
"""

import pytest
import torch

from mkhe_tpu_torch.ops import ntt_cuda
from mkhe_tpu_torch.ops.primes import ntt_primes
from mkhe_tpu_torch.ops.ring import Ring

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


def _ring(logn, limbs=3):
    mods = ntt_primes(logn, 28.9, 1) + ntt_primes(logn, 27.0, limbs - 1)
    return Ring.create(mods, logn, "cuda")


def _rand(gen, shape, bound):
    return torch.randint(0, 1 << 62, shape, generator=gen,
                         dtype=torch.int64, device="cuda") % bound


@pytest.mark.parametrize("logn", [1, 2, 4, 9, 10, 11, 14, 15])
def test_kernels_match_plain(gen, logn):
    ring = _ring(logn)
    q = ring.q[:, None]
    fwd = (ring.q, ring.bar, ring.psi, ring.psi_sh)
    inv = (ring.q, ring.bar, ring.ipsi, ring.ipsi_sh, ring.ninv,
           ring.ninv_sh)
    shape = (2, 3, ring.nlimbs, ring.n)
    for x in (_rand(gen, shape, q), _rand(gen, shape, 1 << 32)):
        assert torch.equal(ntt_cuda.ntt(x, *fwd), ntt_cuda.ntt_plain(x, *fwd))
    x = _rand(gen, shape, 8 * q)
    assert torch.equal(ntt_cuda.intt(x, *inv), ntt_cuda.intt_plain(x, *inv))
    x = _rand(gen, shape, q)
    assert torch.equal(ring.intt(ring.ntt(x)), x)
    torch.cuda.synchronize()


def test_launch_counters(gen):
    ring = _ring(10)
    x = _rand(gen, (ring.nlimbs, ring.n), ring.q[:, None])
    ntt_cuda.reset_counters()
    ring.intt(ring.ntt(ring.ntt(x)))
    ntt_cuda.ntt_plain(x, ring.q, ring.bar, ring.psi, ring.psi_sh)
    assert (ntt_cuda.fwd_launches, ntt_cuda.inv_launches) == (2, 1)


def test_wrapper_raises_on_cuda(gen):
    ring = _ring(10)
    x = _rand(gen, (ring.nlimbs, ring.n), ring.q[:, None])
    with pytest.raises(TypeError):
        ntt_cuda.ntt(x.to(torch.int32), ring.q, ring.bar, ring.psi,
                     ring.psi_sh)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x.t(), ring.q, ring.bar, ring.psi, ring.psi_sh)
    with pytest.raises(ValueError):
        ntt_cuda.ntt(x, ring.q.cpu(), ring.bar, ring.psi, ring.psi_sh)
    big = _ring(16, limbs=1)
    with pytest.raises(ValueError):
        big.ntt(torch.zeros((1, big.n), dtype=torch.int64, device="cuda"))
