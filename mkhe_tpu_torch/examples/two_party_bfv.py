"""Two-party multi-key BFV walkthrough on the port (exact arithmetic
mod T = 65537).

Alice and Bob each hold their own secret key; ciphertexts encrypted under
either key combine homomorphically with EXACT results mod T, and
decryption needs both parties' keys (reference behaviour:
mkbfv/mkbfv_test.go's multi-user mult, require.Equal). The slots form two
rows of N/2; a rotation moves the columns of both rows.

Run: python -m mkhe_tpu_torch.examples.two_party_bfv [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from mkhe_tpu_torch import mkbfv, mkrlwe
from mkhe_tpu_torch.ops.primes import ntt_primes

T = 65537


def cmod(x):
    """x mod T, centered."""
    r = np.mod(x, T)
    return np.where(r > T // 2, r - T, r)


def main(device=None) -> None:
    # small demo parameters (double RNS basis R = Q * QMul, per
    # mkbfv/params.go:36-81 of the reference)
    logn = 10
    q = ntt_primes(logn, 26.5, 5)
    qmul = ntt_primes(logn, 26.5, 5, skip=5)
    p = ntt_primes(logn, 28.4, 2)
    params = mkbfv.new_parameters(logn, q, qmul, p, t=T, device=device)

    kgen = mkbfv.KeyGenerator(params, seed=11)
    sk_set = mkrlwe.SecretKeySet()
    pk_set = mkrlwe.PublicKeySet()
    rlk_set = mkbfv.RelinearizationKeySet()
    rtk_set = mkrlwe.RotationKeySet()
    for uid in ("alice", "bob"):
        sk, pk = kgen.gen_key_pair(uid)
        sk_set.add(sk)
        pk_set.add(pk)
        rlk_set.add(kgen.gen_relinearization_key_bfv(
            sk, kgen.gen_secret_key(uid)))
        rtk_set.add(kgen.gen_rotation_key(1, sk))

    enc = mkbfv.Encryptor(params, seed=12)
    dec = mkbfv.Decryptor(params)
    ev = mkbfv.Evaluator(params)

    rng = np.random.default_rng(0)
    ma = rng.integers(-100, 100, size=params.n, dtype=np.int64)
    mb = rng.integers(-100, 100, size=params.n, dtype=np.int64)

    ct_a = enc.encrypt_msg(ma, pk_set.get("alice"))
    ct_b = enc.encrypt_msg(mb, pk_set.get("bob"))

    # homomorphic ops across the two keys: each result is a 2-party ct
    ct_sum = ev.add_new(ct_a, ct_b)
    ct_prod = ev.mul_relin_new(ct_a, ct_b, rlk_set)
    ct_rot = ev.rotate_new(ct_prod, 1, rtk_set)

    out_sum = dec.decrypt(ct_sum, sk_set)
    out_prod = dec.decrypt(ct_prod, sk_set)
    out_rot = dec.decrypt(ct_rot, sk_set)
    nh = params.n // 2
    prod = cmod(ma * mb)

    for name, got, want in (
            ("sum", out_sum, cmod(ma + mb)), ("product", out_prod, prod),
            ("rotation", out_rot, np.concatenate(
                [np.roll(prod[:nh], -1), np.roll(prod[nh:], -1)]))):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name} mismatch")
    print(f"2-party BFV: sum, product and rotation EXACT mod {T} "
          f"on all {params.n} slots ({params.rlwe.device})")
    print("first 8 slots:", "a =", ma[:8], "| b =", mb[:8])
    print("               a*b =", out_prod[:8])


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
