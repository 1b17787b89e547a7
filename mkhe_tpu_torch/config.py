"""Device choice and the NTT's form for the port.

Every constructor takes `device=`; None means DEFAULT_DEVICE. There is no
"auto" mode: asking for CUDA on a machine without a card raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"

# Run the NTT's 7 small butterfly stages as one fixed 128x128 map per limb
# (int8 digit planes on the tensor cores, ops/ntt_cuda.tail) after a head
# kernel that runs the stages with half-block >= 128; the counterpart of
# mkhe_tpu.config.pallas_ntt_mxu_tail, default off as there. It applies
# only for N >= 256 and is read at every Ring.ntt / Ring.intt call.
# Outputs are bit-identical either way.
ntt_mxu_tail: bool = False


def get_device(device=None) -> torch.device:
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
