"""Two-party multi-key CKKS walkthrough on the port.

Alice and Bob each hold their own secret key; ciphertexts encrypted under
either key combine homomorphically, and decryption needs BOTH parties'
partial decryptions (the MPC deployment shape of
mkrlwe.Decryptor.PartialDecrypt). The rotation key comes from the default
parameters: their CRS set already holds every power of two.

Run: python -m mkhe_tpu_torch.examples.two_party_ckks [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mkhe_tpu_torch import mkckks, mkrlwe


def _timed(device: torch.device, times: dict, name: str, fn):
    """fn(), with its wall ms (the device synchronized) under times[name]."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    times[name] = (time.perf_counter() - t0) * 1e3
    return out


def main(device=None) -> float:
    """Runs the walkthrough; returns the max slot error."""
    # small demo parameters (mkckks.PN15QP880() for production scale)
    params = mkckks.new_parameters(
        12, 11, q0_bits=28.9, level_bits=26.0, levels=3, scale=2.0 ** 52,
        p_bits=28.4, p_count=4, device=device)
    dev = params.rlwe.device

    kgen = mkrlwe.KeyGenerator(params.rlwe)
    sk_set = mkrlwe.SecretKeySet()
    pk_set = mkrlwe.PublicKeySet()
    rlk_set = mkrlwe.RelinearizationKeySet()
    rtk_set = mkrlwe.RotationKeySet()
    for who in ("alice", "bob"):
        sk, pk = kgen.gen_key_pair(who)
        sk_set.add(sk)
        pk_set.add(pk)
        rlk_set.add(kgen.gen_relinearization_key(
            sk, kgen.gen_secret_key(who)))
        rtk_set.add(kgen.gen_rotation_key(1, sk))

    enc = mkckks.Encryptor(params)
    dec = mkckks.Decryptor(params)
    ev = mkckks.Evaluator(params)

    rng = np.random.default_rng(0)
    za = rng.uniform(-1, 1, params.slots)
    zb = rng.uniform(-1, 1, params.slots)

    ct_a = enc.encrypt_msg(mkckks.Message(value=za), pk_set.get("alice"))
    ct_b = enc.encrypt_msg(mkckks.Message(value=zb), pk_set.get("bob"))

    # homomorphic (za + zb) * za, then rotate left by 1, timed per op
    times = {}
    ct_sum = _timed(dev, times, "add", lambda: ev.add_new(ct_a, ct_b))
    ct_prod = _timed(dev, times, "mul_relin",
                     lambda: ev.mul_relin_new(ct_sum, ct_a, rlk_set))
    ct_rot = _timed(dev, times, "rotate",
                    lambda: ev.rotate_new(ct_prod, 1, rtk_set))

    # distributed decryption: alice partially decrypts, then bob
    partial = dec.partial_decrypt(ct_rot, sk_set.get("alice"))
    partial = dec.partial_decrypt(partial, sk_set.get("bob"))
    out = dec.decrypt(partial, sk_set)  # no ids left; returns the message

    want = np.roll((za + zb) * za, -1)
    err = float(np.max(np.abs(out.value.real - want)))
    print(", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" ({dev})")
    print(f"slots={params.slots}  max |err| = {err:.2e}")
    if not err < 1e-6:
        raise AssertionError(f"slot error {err:.2e} above 1e-6")
    print("two-party encrypted computation verified")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(ap.parse_args().device)
