"""Multi-key RLWE core (port of mkhe_tpu/mkrlwe)."""

from .params import Parameters, new_parameters, add_crs
from .elements import (Ciphertext, HoistedCiphertext, new_ciphertext,
                       pad_ciphertext, drop_level, union_ids,
                       batch_counters, reset_batch_counters)
from .keys import (SecretKey, PublicKey, SwitchingKey, RelinearizationKey,
                   RotationKey, ConjugationKey, SecretKeySet, PublicKeySet,
                   RelinearizationKeySet, RotationKeySet, ConjugationKeySet)
from .idset import IDSet
from .keygen import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from . import keyswitch

__all__ = [
    "Parameters", "new_parameters", "add_crs",
    "Ciphertext", "HoistedCiphertext", "new_ciphertext", "pad_ciphertext",
    "drop_level", "union_ids", "batch_counters", "reset_batch_counters",
    "SecretKey", "PublicKey", "SwitchingKey", "RelinearizationKey",
    "RotationKey", "ConjugationKey", "SecretKeySet", "PublicKeySet",
    "RelinearizationKeySet", "RotationKeySet", "ConjugationKeySet",
    "IDSet", "KeyGenerator", "Encryptor", "Decryptor", "keyswitch",
]
