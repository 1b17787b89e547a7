"""Multi-key RLWE core (port of mkhe_tpu/mkrlwe)."""

from .params import Parameters, new_parameters
from .elements import Ciphertext, HoistedCiphertext, drop_level, union_ids
from .keys import (SecretKey, PublicKey, SwitchingKey, RelinearizationKey,
                   SecretKeySet, PublicKeySet, RelinearizationKeySet)
from .keygen import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from . import keyswitch

__all__ = [
    "Parameters", "new_parameters",
    "Ciphertext", "HoistedCiphertext", "drop_level", "union_ids",
    "SecretKey", "PublicKey", "SwitchingKey", "RelinearizationKey",
    "SecretKeySet", "PublicKeySet", "RelinearizationKeySet",
    "KeyGenerator", "Encryptor", "Decryptor", "keyswitch",
]
