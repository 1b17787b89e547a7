"""The two-party CNN's plain forward pass and the scale and level at which
the encrypted pipeline leaves its logits.

plain_forward is a frozen copy of the model's float64 forward pass
(cnn/cnn.go:10-96): a 4x4 stride-2 convolution of num_kernels kernels,
square, fc1 + b1, square, fc2 + b2. output_scale_level follows the
pipeline's rescales with the scheme's rule (reference.ckks.rescale): each
product rescales at the lower level of its operands, an addition keeps
the larger scale and the lower level.
"""

from __future__ import annotations

import numpy as np
import torch

from .ckks import rescale


def plain_forward(image, kernels, fc1, fc2, b1, b2, layout: dict,
                  dtype=torch.float64) -> np.ndarray:
    """The logits (classes,), every step computed in `dtype` on the CPU;
    returned as float64."""
    k = layout["ksize"]
    image, kernels, fc1, fc2, b1, b2 = (
        torch.as_tensor(np.asarray(a, np.float64)).to(dtype)
        for a in (image, kernels, fc1, fc2, b1, b2))
    patches = image.unfold(0, k, 2).unfold(1, k, 2)      # (co, co, k, k)
    conv = torch.einsum("ijab,cab->ijc", patches, kernels)
    x = conv.reshape(-1)                                 # i + 5 (j 13 + k)
    x = x * x
    x = fc1.T @ x + b1
    x = x * x
    return (fc2.T @ x + b2).to(torch.float64).numpy()


def output_scale_level(moduli, scale: float, top: int):
    """(scale, level) of the pipeline's output; every input is encrypted
    at `scale` and level `top`, the fc2 mask is encoded at `scale`."""
    def mul(s, l, s2=scale):
        return rescale(s * s2, l, moduli, scale)
    s, l = mul(scale, top)                  # conv: image x kernels
    s, l = mul(s, l, s)                     # square
    s, l = mul(s, l)                        # fc1 x diagonals
    s = max(s, scale)                       # + b1
    s, l = mul(s, l, s)                     # square
    s, l = mul(s, l)                        # x mask plaintext
    s, l = mul(s, l)                        # x fc2
    return max(s, scale), l                 # + b2
