"""Multi-key CKKS scheme (port of mkhe_tpu/mkckks)."""

from .params import (Parameters, new_parameters, select_moduli,
                     from_literal, PN15QP880, PN14QP439, PN14QP433_CNN)
from .elements import Ciphertext, Message, new_message
from .encryptor import Encryptor
from .decryptor import Decryptor
from .evaluator import Evaluator
from . import encoder

__all__ = [
    "Parameters", "new_parameters", "select_moduli", "from_literal",
    "PN15QP880", "PN14QP439", "PN14QP433_CNN", "Ciphertext", "Message",
    "new_message",
    "Encryptor", "Decryptor", "Evaluator", "encoder",
]
