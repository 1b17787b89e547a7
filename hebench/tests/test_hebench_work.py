"""work.py's inventory against the calls and shapes the port's NTT and
key-switching entry points receive on the CPU route: the 4-party mult and
the plaintext mult at logN 10, one staged CNN inference at the MINI
layout (alpha 1 and 2). The wrappers below record every call."""

import collections
import contextlib
import math

import numpy as np
import pytest
import torch

from _tiny import CKKS, HOME, MINI, mini_weights
from hebench import harness
from hebench.reference import primes

MULRELIN, PTMUL, CNN = (harness.kind(HOME, k) for k in
                        ("ckks_mulrelin", "ckks_ptmul", "cnn"))


def _distinct(t) -> int:
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st)


@contextlib.contextmanager
def recorded():
    """Every ntt / intt / digit mod_up / mod_down / mul_accum call, in
    work.py's form (coefficient counts in units of N)."""
    from mkhe_tpu_torch.ops import basis_cuda, ntt_cuda
    calls, saved = [], {}

    def wrap(mod, name, note):
        fn = getattr(mod, name)
        saved[(mod, name)] = fn

        def inner(*args):
            out = fn(*args)
            calls.append(note(out, *args))
            return out
        setattr(mod, name, inner)

    def transform(kind):
        return lambda out, x, *_: (kind, math.prod(x.shape[:-2]), x.shape[-2])

    wrap(ntt_cuda, "ntt", transform("ntt"))
    wrap(ntt_cuda, "intt", transform("intt"))
    wrap(basis_cuda, "decompose", lambda out, x, t: (
        "mod_up", math.prod(x.shape[:-1]), math.prod(out.shape[:-1])))
    wrap(basis_cuda, "mod_down", lambda out, xq, xp, t: (
        "mod_down", math.prod(xq.shape[:-2]), xq.shape[-2], xp.shape[-2]))
    wrap(basis_cuda, "mul_accum", lambda out, a, b, n, t: (
        "mul_accum", _distinct(a) // a.shape[-1], _distinct(b) // b.shape[-1],
        math.prod(out.shape[:-1])))
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _keys(params, users, seed=3):
    from mkhe_tpu_torch import mkrlwe
    kgen = mkrlwe.KeyGenerator(params.rlwe, seed=seed)
    rlk, pks = mkrlwe.RelinearizationKeySet(), {}
    for u in users:
        sk, pks[u] = kgen.gen_key_pair(u)
        rlk.add(kgen.gen_relinearization_key(sk, kgen.gen_secret_key(u)))
    return rlk, pks


def test_mult_and_plaintext_mult():
    from mkhe_tpu_torch import mkckks
    p = CKKS["params"]
    params = mkckks.new_parameters(**p, device="cpu")
    users = [f"u{i}" for i in range(4)]
    rlk, pks = _keys(params, users)
    enc, ev = mkckks.Encryptor(params, seed=4), mkckks.Evaluator(params)
    msg = mkckks.Message(value=np.full(params.slots, 0.1 + 0j))
    cts = [enc.encrypt_msg(msg, pks[u]) for u in users]
    ct0 = ct1 = cts[0]
    for c in cts[1:]:
        ct0, ct1 = ev.add_new(ct0, c), ev.sub_new(ct1, c)
    moduli = primes.ckks_moduli(**p)
    cfg = dict(p, parties=4)
    with recorded() as calls:
        ev.mul_relin_new(ct0, ct1, rlk)
    assert collections.Counter(calls) == collections.Counter(
        MULRELIN.inventory(cfg, moduli).calls)
    pt = torch.from_numpy(enc.encode_msg(msg).astype(np.int64))
    with recorded() as calls:
        ev.mul_ptxt_new(ct0, pt, params.scale)
    assert collections.Counter(calls) == collections.Counter(
        PTMUL.inventory(cfg, moduli).calls)


@pytest.mark.parametrize("p_count", [2, 4])
def test_cnn_inference(p_count):
    from mkhe_tpu_torch import mkckks, profile_cnn
    from mkhe_tpu_torch.models import cnn
    p = dict(logn=11, logslots=10, q0_bits=28.9, level_bits=20.0, levels=7,
             scale=2.0 ** 40, p_bits=28.4, p_count=p_count, gamma=2)
    params = mkckks.new_parameters(**p, device="cpu")
    lo = cnn.Layout(**{k: v for k, v in MINI.items()})
    w = mini_weights()
    s = profile_cnn.setup(params, lo, tuple(w[k] for k in (
        "kernels", "fc1", "fc2", "b1", "b2")), seed=5)
    ct = s.encrypt_image(profile_cnn.image(lo, 1))
    with recorded() as calls:
        profile_cnn.infer(s, ct)
    inv = CNN.inventory(dict(p, layout=MINI), primes.ckks_moduli(**p))
    assert collections.Counter(calls) == collections.Counter(inv.calls)
    assert CNN.extra_rots(MINI) == lo.extra_rots
