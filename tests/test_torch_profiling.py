"""The port's last module gaps against the JAX package: utils.profiling
(Timer, the H100 roofline over profile_ntt.kernel_work), Ring.zero,
Ring.from_mont and primes.bit_reverse, bit for bit where the values are
integers."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mkhe_tpu.ops import primes as jprimes
from mkhe_tpu.ops import ring as jring
from mkhe_tpu.utils import profiling as jprof
from mkhe_tpu_torch import profile_ntt
from mkhe_tpu_torch.ops import primes as tprimes
from mkhe_tpu_torch.ops import ring as tring
from mkhe_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

LOGN = 8
MODS = tprimes.ntt_primes(LOGN, 28.9, 1) + tprimes.ntt_primes(LOGN, 27.0, 3)


def test_timer_regions_and_summary():
    """Each region appends its seconds under its label; a CPU tensor or
    device as sync_out is accepted (no card to synchronize); the summary
    has the JAX Timer's format."""
    timer = tprof.Timer()
    x = torch.ones(4)
    for _ in range(2):
        with timer.region("add", sync_out=x):
            x = x + 1
    with timer.region("mul", sync_out=torch.device("cpu")):
        x = x * 2
    with timer.region("none"):
        pass
    assert [len(timer.records[k]) for k in ("add", "mul", "none")] == [2, 1, 1]
    assert all(t >= 0 for v in timer.records.values() for t in v)
    lines = timer.summary().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["add", "mul", "none"]
    pat = r"^\w+: n=\d+ mean=\d+\.\d{3}ms min=\d+\.\d{3}ms$"
    assert all(re.match(pat, ln) for ln in lines)
    jt = jprof.Timer()
    with jt.region("add"):
        pass
    assert re.match(pat, jt.summary())


@pytest.mark.parametrize("logn,nlimbs", [(15, 32), (14, 18), (10, 3)])
def test_roofline_is_the_cards(logn, nlimbs):
    """The floor is profile_ntt.kernel_bound's for ntt_fwd on (nlimbs,
    2^logn) with q, Barrett and the packed twiddles, in us, and the report
    has the JAX package's format."""
    r = tprof.ntt_roofline_us(logn, nlimbs)
    meta = dict(dtype=torch.int64, device="meta")
    x = torch.empty((nlimbs, 1 << logn), **meta)
    ms, by = profile_ntt.kernel_bound(
        "ntt_fwd", x, (torch.empty(nlimbs, **meta),) * 2 + (x,))
    assert max(r.values()) == pytest.approx(1e3 * ms, rel=1e-12)
    assert (r["memory_us"] >= r["compute_us"]) == (by == "bytes")
    # the card's rate, not the TPU model's 800 GB/s
    assert r["memory_us"] < jprof.ntt_roofline_us(logn, nlimbs)["memory_us"]
    rep = tprof.roofline_report(logn, nlimbs, 50.0)
    want = jprof.roofline_report(logn, nlimbs, 50.0)
    strip = lambda s: re.sub(r"\d+\.\d+", "#", s)  # noqa: E731
    assert strip(rep) == strip(want)
    assert f"floor {max(r.values()):.1f} us" in rep


def test_ring_zero_and_from_mont():
    jr = jring.Ring.create(MODS, LOGN)
    tr = tring.Ring.create(MODS, LOGN, "cpu")
    z = tr.zero(2, 3)
    assert z.shape == (2, 3, len(MODS), 1 << LOGN) and z.dtype == torch.int64
    np.testing.assert_array_equal(z.numpy(), np.asarray(jr.zero(2, 3)))
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, (3, len(MODS), 1 << LOGN), dtype=np.uint64)
    got = tr.from_mont(torch.from_numpy(a.astype(np.int64)))
    want = jr.from_mont(jnp.asarray(a.astype(np.uint32)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(tr.from_mont(tr.to_mont(got)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("bits", [0, 1, 5, 15, 16])
def test_bit_reverse(bits):
    for x in range(min(1 << bits, 1 << 12)):
        assert tprimes.bit_reverse(x, bits) == jprimes.bit_reverse(x, bits)
    if bits:
        assert tprimes.bit_reverse(1, bits) == 1 << (bits - 1)
