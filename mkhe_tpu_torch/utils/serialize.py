"""Key and ciphertext serialization (port of mkhe_tpu/utils/serialize.py).

npz save and load of secret, relinearization and rotation keys and of
ciphertexts, in the JAX package's file layout: the same keys, and limbs
as uint32 (the port's int64 tensors hold u32 values), so a file written
by either package loads in the other. Loading gives int64 tensors on the
device the caller names (default: the card).
"""

from __future__ import annotations

import numpy as np

from .. import mkrlwe
from ..convert import tensor, to_numpy
from ..mkrlwe.elements import Ciphertext


def save_ciphertext(path: str, ct: Ciphertext, scale: float | None = None):
    meta = dict(ids=np.array(list(ct.ids)), data=to_numpy(ct.data))
    if scale is not None:
        meta["scale"] = np.float64(scale)
    np.savez_compressed(path, **meta)


def load_ciphertext(path: str, device=None):
    """(Ciphertext, scale or None)."""
    z = np.load(path, allow_pickle=False)
    ct = Ciphertext(ids=tuple(str(s) for s in z["ids"]),
                    data=tensor(z["data"], device))
    return ct, float(z["scale"]) if "scale" in z else None


def save_secret_key(path: str, sk: mkrlwe.SecretKey):
    np.savez_compressed(path, id=np.array(sk.id), data=to_numpy(sk.data))


def load_secret_key(path: str, device=None) -> mkrlwe.SecretKey:
    z = np.load(path, allow_pickle=False)
    return mkrlwe.SecretKey(id=str(z["id"]), data=tensor(z["data"], device))


# Relin-key format version. 2: b and d in the NTT domain in
# DOUBLE-Montgomery form (keys.py); 1 (never stamped) stored them in
# single-Montgomery form and would multiply to garbage under the current
# convention, so it is refused.
RELIN_FMT = 2


def save_relin_key(path: str, rlk: mkrlwe.RelinearizationKey):
    np.savez_compressed(path, id=np.array(rlk.id), b=to_numpy(rlk.b),
                        d=to_numpy(rlk.d), v=to_numpy(rlk.v),
                        fmt=np.int64(RELIN_FMT))


def load_relin_key(path: str, device=None) -> mkrlwe.RelinearizationKey:
    z = np.load(path, allow_pickle=False)
    fmt = int(z["fmt"]) if "fmt" in z else 1
    if fmt != RELIN_FMT:
        raise ValueError(
            f"relin key checkpoint {path!r} has format {fmt}, expected "
            f"{RELIN_FMT}: it predates the double-Montgomery b/d key "
            "convention and would decrypt to garbage if loaded; "
            "regenerate it with KeyGenerator.gen_relinearization_key")
    return mkrlwe.RelinearizationKey(
        id=str(z["id"]), b=tensor(z["b"], device), d=tensor(z["d"], device),
        v=tensor(z["v"], device))


def save_rotation_key(path: str, rtk: mkrlwe.RotationKey):
    np.savez_compressed(path, id=np.array(rtk.id),
                        rot_idx=np.int64(rtk.rot_idx), data=to_numpy(rtk.data))


def load_rotation_key(path: str, device=None) -> mkrlwe.RotationKey:
    z = np.load(path, allow_pickle=False)
    return mkrlwe.RotationKey(id=str(z["id"]), rot_idx=int(z["rot_idx"]),
                              data=tensor(z["data"], device))
