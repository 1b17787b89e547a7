"""The CUDA NTT kernels (mkhe_tpu_torch/csrc/ntt.cu, and the split NTT's
head, tail and tailed inverse in csrc/ntt_tail.cu) against their plain
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


def _split_args(ring):
    t = ring.split_tables()
    head = (ring.q, t.twist, t.twist_sh, t.wpack, t.wpack_sh)
    inv = (ring.q, ring.bar, t.iwpack, t.iwpack_sh, t.untwist, t.untwist_sh)
    return t, head, inv


@pytest.mark.parametrize("logn", [8, 9, 10, 12, 14, 15])
def test_split_kernels_match_plain(gen, logn):
    """Head, tail (both maps) and tailed inverse against their plain
    versions; head + tail against ntt_fwd_kernel, tail + tailed inverse
    against ntt_inv_kernel; any-u32 and < 8q inputs."""
    ring = _ring(logn)
    t, head, inv = _split_args(ring)
    q = ring.q[:, None]
    shape = (2, 3, ring.nlimbs, ring.n)
    fwd_t = (ring.q, ring.bar, ring.psi, ring.psi_sh)
    inv_t = (ring.q, ring.bar, ring.ipsi, ring.ipsi_sh, ring.ninv,
             ring.ninv_sh)
    x = _rand(gen, shape, 1 << 32)
    h = ntt_cuda.ntt_head(x, *head)
    assert torch.equal(h, ntt_cuda.ntt_head_plain(x, *head))
    for mat in (t.tail_fwd, t.tail_inv):
        args = (ring.q, ring.r_inv, mat, t.tail_pow)
        assert torch.equal(ntt_cuda.tail(x, *args),
                           ntt_cuda.tail_plain(x, *args))
    fwd = ntt_cuda.tail(h, ring.q, ring.r_inv, t.tail_fwd, t.tail_pow)
    assert torch.equal(fwd, ntt_cuda.ntt(x, *fwd_t))
    y = _rand(gen, shape, 8 * q)
    tailed = ntt_cuda.tail(y, ring.q, ring.r_inv, t.tail_inv, t.tail_pow)
    got = ntt_cuda.intt_tailed(tailed, *inv)
    assert torch.equal(got, ntt_cuda.intt_tailed_plain(tailed, *inv))
    assert torch.equal(got, ntt_cuda.intt(y, *inv_t))
    torch.cuda.synchronize()


def test_split_routing_and_counters(gen):
    """With config.ntt_mxu_tail the ring runs head -> tail and tail ->
    tailed inverse, and only kernel launches count."""
    from mkhe_tpu_torch import config
    ring = _ring(10)
    x = _rand(gen, (ring.nlimbs, ring.n), ring.q[:, None])
    want = ring.ntt(x)
    ntt_cuda.reset_counters()
    config.ntt_mxu_tail = True
    try:
        got = ring.ntt(x)
        back = ring.intt(got)
    finally:
        config.ntt_mxu_tail = False
    assert torch.equal(got, want) and torch.equal(back, x)
    assert ntt_cuda.counters() == {"ntt_fwd": 0, "ntt_inv": 0,
                                   "ntt_fwd_head": 1, "ntt_tail": 2,
                                   "ntt_inv_tailed": 1}
