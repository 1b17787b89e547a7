"""Multi-key BFV scheme (port of mkhe_tpu/mkbfv): exact mult + relin in
the double basis R = Q ++ QMul."""

from .params import Parameters, new_parameters, PN15QP880, PN14QP439
from .keys import RelinearizationKey, RelinearizationKeySet
from .keygen import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from .evaluator import Evaluator
from .keyswitch import HoistedCiphertext
from . import encoder, basis, keyswitch

__all__ = [
    "Parameters", "new_parameters", "PN15QP880", "PN14QP439",
    "RelinearizationKey", "RelinearizationKeySet", "KeyGenerator",
    "Encryptor", "Decryptor", "Evaluator", "HoistedCiphertext",
    "encoder", "basis", "keyswitch",
]
