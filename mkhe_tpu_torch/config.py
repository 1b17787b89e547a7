"""Device choice for the port.

Every constructor takes `device=`; None means DEFAULT_DEVICE. There is no
"auto" mode: asking for CUDA on a machine without a card raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


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
