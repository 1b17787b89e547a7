"""Two-party encrypted MNIST CNN inference (port of mkhe_tpu/models/cnn.py).

The model: a 5-kernel 4x4 stride-2 convolution, square activation, an
845->64 fully-connected layer, square, and a 64->10 classifier, evaluated
under multi-key CKKS between a dataOwner (encrypted image) and a
modelOwner (encrypted weights); cnn/cnn.go:10-96 and the packing encoders
of cnn/cnn_test.go:353-544.

The layout, the packing encoders and plain_forward are numpy, copied from
the JAX package (importing it would load JAX); tests/test_torch_cnn.py
holds them equal. The encrypted layers and _pipeline run on the port's
evaluator. build_fused_inference is the counterpart of the JAX package's
(one XLA program for the whole inference): the staged pipeline captured
as one CUDA graph by fuse.py, its 12 hoistings of the model's
ciphertexts inside, as in the JAX program.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np

from .. import mkckks
from ..utils.profiling import span

WEIGHTS = (Path(__file__).resolve().parents[2] / "mkhe_tpu" / "models"
           / "data" / "cnn_weights.npz")


@dataclasses.dataclass(frozen=True)
class Layout:
    """SIMD packing geometry of the CNN pipeline.

    The defaults are the reference's MNIST constants (cnn/cnn_test.go:
    353-544); every packed index below derives from these, so the same
    packing/layer code also runs at reduced geometry (see MINI, which
    tests/test_torch_cnn.py drives through the full
    conv->sq->fc1->sq->fc2 pipeline at logN=11).

    Invariants: num_kernels * block^2 <= quad (conv vector fits one
    quadrant), fc_units * gap == slots (fc1's diagonal blocks tile the
    slot space), 16 <= gap (fc2's replicate-to-16 gather covers the 10
    classes), classes <= gap.
    """
    image: int = 28         # input image is image x image
    num_kernels: int = 5
    ksize: int = 4          # kernel size (stride is 2)
    fc_units: int = 64
    classes: int = 10
    quad: int = 1024        # quadrant stride of the 4 strided sub-images
    gap: int = 128          # slot stride between fc-unit lanes

    @property
    def block(self) -> int:         # stride-2 sub-image size
        return self.image // 2

    @property
    def conv_out(self) -> int:      # conv output positions per axis
        return (self.image - self.ksize) // 2 + 1

    @property
    def half(self) -> int:          # duplication offset
        return 4 * self.quad

    @property
    def slots(self) -> int:
        return 8 * self.quad

    @property
    def n_diag(self) -> int:        # fc1 diagonal block count
        return self.quad // self.gap

    @property
    def extra_rots(self):
        """Rotation indices needed beyond powers of two
        (cnn/cnn_test.go:185-189 for the reference layout)."""
        s = self.slots
        rots = {self.block, self.block + 1,
                *(i * self.gap for i in range(1, self.n_diag)),
                *(s - (1 << i) for i in range(4))}
        pows = {1 << i for i in range(15)}
        return tuple(sorted(r for r in rots if r not in pows))


REF = Layout()
# Reduced geometry for fast end-to-end tests: 8x8 image,
# 4x4 stride-2 kernels (conv_out 3), 5 kernels, 32 fc units, 10 classes,
# 1024 slots (logN=11). Same code paths, ~1/8 the data of the MNIST
# layout.
MINI = Layout(image=8, fc_units=32, quad=128, gap=32)

# REF's fields under the JAX package's module names
IMAGE = REF.image
NUM_KERNELS = REF.num_kernels
KSIZE = REF.ksize
BLOCK = REF.block   # stride-2 sub-image size
CONV_OUT = REF.conv_out
FC_UNITS = REF.fc_units
CLASSES = REF.classes
GAP = REF.gap
# rotation indices needed beyond powers of two (cnn/cnn_test.go:185-189)
EXTRA_ROTS = REF.extra_rots


def load_weights():
    """(kernels, fc1, fc2, b1, b2) of the model, read from the JAX
    package's data file by path (nothing of mkhe_tpu is imported)."""
    with np.load(WEIGHTS) as w:
        return (w["kernels"], w["fc1"], w["fc2"], w["b1"], w["b2"])


# ----------------------------------------------------------------------------
# SIMD packing encoders (cnn/cnn_test.go:353-544)
# ----------------------------------------------------------------------------

def pack_image(image: np.ndarray, slots: int,
               layout: Layout = REF) -> np.ndarray:
    """28x28 image -> strided 4-block packing, duplicated (cnn_test:353)."""
    lo = layout
    enc = np.zeros(slots, np.complex128)
    for k in range(lo.num_kernels):
        for i in range(lo.block):
            for j in range(lo.block):
                idx = lo.block * lo.block * k + lo.block * i + j
                enc[idx] = image[2 * i][2 * j]
                enc[idx + lo.quad] = image[2 * i][2 * j + 1]
                enc[idx + 2 * lo.quad] = image[2 * i + 1][2 * j]
                enc[idx + 3 * lo.quad] = image[2 * i + 1][2 * j + 1]
    enc[lo.half:2 * lo.half] = enc[:lo.half]
    return enc


def pack_kernels(kernels: np.ndarray, slots: int,
                 layout: Layout = REF) -> List[np.ndarray]:
    """5 kernels of 4x4 -> 4 packed vectors (cnn_test:388-441)."""
    lo = layout
    out = [np.zeros(slots, np.complex128) for _ in range(4)]
    # sub-kernel coordinate pairs per packed vector and per quadrant
    picks = [  # (vector, quadrant) -> (row, col) in the 4x4 kernel
        [(0, 0), (0, 1), (1, 0), (1, 1)],   # vector 0
        [(0, 2), (0, 3), (1, 2), (1, 3)],   # vector 1
        [(2, 0), (2, 1), (3, 0), (3, 1)],   # vector 2
        [(2, 2), (2, 3), (3, 2), (3, 3)],   # vector 3
    ]
    for i in range(lo.num_kernels):
        for j in range(lo.conv_out):
            for kk in range(lo.conv_out):
                base = lo.block * lo.block * i + lo.block * j + kk
                for v in range(4):
                    for quad in range(4):
                        r, c = picks[v][quad]
                        out[v][base + lo.quad * quad] = kernels[i][r][c]
    for v in range(4):
        out[v][lo.half:2 * lo.half] = out[v][:lo.half]
    return out


def pack_fc1(fc1: np.ndarray, slots: int,
             layout: Layout = REF) -> List[np.ndarray]:
    """845x64 matrix -> 8 diagonal-packed vectors (cnn_test:443-486)."""
    lo = layout
    tmp = np.zeros((lo.fc_units, lo.quad), np.complex128)
    for i in range(lo.num_kernels):
        for j in range(lo.conv_out):
            for k in range(lo.conv_out):
                for l in range(lo.fc_units):
                    tmp[l][lo.block * lo.block * i + lo.block * j + k] = \
                        fc1[i + lo.num_kernels * (j * lo.conv_out + k)][l]
    out = [np.zeros(slots, np.complex128) for _ in range(lo.n_diag)]
    for i in range(lo.n_diag):
        for j in range(lo.fc_units):
            for k in range(lo.gap):
                out[i][lo.gap * j + k] = \
                    tmp[j][lo.gap * ((i + j) % lo.n_diag) + k]
    return out


def pack_fc2(fc2: np.ndarray, slots: int,
             layout: Layout = REF) -> np.ndarray:
    enc = np.zeros(slots, np.complex128)
    for i in range(slots):
        x, y = i // layout.gap, i % layout.gap
        if y < layout.classes and x < layout.fc_units:
            enc[i] = fc2[x][y]
    return enc


def pack_b1(b1: np.ndarray, slots: int, layout: Layout = REF) -> np.ndarray:
    enc = np.zeros(slots, np.complex128)
    for i in range(layout.fc_units):
        enc[i * layout.gap] = b1[i]
    return enc


def pack_b2(b2: np.ndarray, slots: int, layout: Layout = REF) -> np.ndarray:
    enc = np.zeros(slots, np.complex128)
    enc[:layout.classes] = b2
    return enc


def mask_vector(slots: int, layout: Layout = REF) -> np.ndarray:
    m = np.zeros(slots, np.complex128)
    m[::layout.gap] = 1
    return m


# ----------------------------------------------------------------------------
# Encrypted layers (cnn/cnn.go)
# ----------------------------------------------------------------------------

def convolution(ev: mkckks.Evaluator, rlk, rtk, ct_image, h_image,
                ct_kernels, h_kernels, layout: Layout = REF):
    """4 hoisted mult+rot combos + rotation-tree fold (cnn/cnn.go:10-40):
    the three image rotations (1, block, block + 1) share one hoisted
    decomposition in one batched pass, and the four kernel products are
    one lazily relinearized inner product (mul_relin_sum_new)."""
    lo = layout
    rots = ev.rotate_hoisted_many_new(
        ct_image, [1, lo.block, lo.block + 1], h_image, rtk)
    pairs = [(ct_image, ct_kernels[0], h_image, h_kernels[0])]
    for tmp, kidx in zip(rots, (1, 2, 3)):
        pairs.append((tmp, ct_kernels[kidx], ev.hoisted_form(tmp),
                      h_kernels[kidx]))
    out = ev.mul_relin_sum_new(pairs, rlk)
    for rot in (2 * lo.quad, lo.quad):
        out = ev.add_new(out, ev.rotate_new(out, rot, rtk))
    return out


def fc1_layer(ev: mkckks.Evaluator, rlk, rtk, ct_vec, h_vec, ct_mat,
              h_mat, ct_bias, layout: Layout = REF):
    """8 diagonal blocks + log-tree over 128 + bias (cnn/cnn.go:42-71):
    the 7 non-identity rotations share one hoisted decomposition in one
    batched pass, and the 8 diagonal products are one lazily
    relinearized inner product."""
    lo = layout
    n = len(ct_mat)
    rots = ev.rotate_hoisted_many_new(
        ct_vec, [i * lo.gap for i in range(1, n)], h_vec, rtk)
    pairs = []
    for i in range(n):
        tmp = ct_vec if i == 0 else rots[i - 1]
        h_tmp = h_vec if i == 0 else ev.hoisted_form(tmp)
        pairs.append((tmp, ct_mat[i], h_tmp, h_mat[i]))
    out = ev.mul_relin_sum_new(pairs, rlk)
    for i in range(lo.gap.bit_length() - 1):  # log2(gap)
        out = ev.add_new(out, ev.rotate_new(out, 1 << i, rtk))
    return ev.add_new(out, ct_bias)


def fc2_layer(ev: mkckks.Evaluator, rlk, rtk, ct_vec, ct_mat, ct_bias,
              pt_mask, mask_scale, layout: Layout = REF):
    """mask, gather, mult, log-tree over 64*128 stride, bias
    (cnn/cnn.go:73-96)."""
    lo = layout
    out = ev.mul_ptxt_new(ct_vec, pt_mask, mask_scale)
    for i in range(4):  # log2(16): replicate each unit to >= 10 slots
        out = ev.add_new(out, ev.rotate_new(out, -(1 << i), rtk))
    out = ev.mul_relin_new(out, ct_mat, rlk)
    for i in range(lo.fc_units.bit_length() - 1):  # log2(fc_units)
        out = ev.add_new(out, ev.rotate_new(out, lo.gap * (1 << i), rtk))
    return ev.add_new(out, ct_bias)


def _pipeline(ev, rlk, rtk, ct_img, ct_k, ct_fc1, ct_fc2, ct_b1, ct_b2,
              pt_mask, mask_scale, layout: Layout = REF):
    """The full inference (cnn_test.go:99-178 order), in three spans:
    cnn.conv (the hoistings of the image and the model, the
    convolution), cnn.fc1 (the square, fc1) and cnn.fc2 (the square,
    fc2)."""
    with span("cnn.conv"):
        h_img = ev.hoisted_form(ct_img)
        h_k = [ev.hoisted_form(c) for c in ct_k]
        h_fc1 = [ev.hoisted_form(c) for c in ct_fc1]
        conv = convolution(ev, rlk, rtk, ct_img, h_img, ct_k, h_k, layout)
    with span("cnn.fc1"):
        h_conv = ev.hoisted_form(conv)
        sq1 = ev.mul_relin_hoisted_new(conv, conv, h_conv, h_conv, rlk)
        h_sq1 = ev.hoisted_form(sq1)
        f1 = fc1_layer(ev, rlk, rtk, sq1, h_sq1, ct_fc1, h_fc1, ct_b1,
                       layout)
    with span("cnn.fc2"):
        h_f1 = ev.hoisted_form(f1)
        sq2 = ev.mul_relin_hoisted_new(f1, f1, h_f1, h_f1, rlk)
        return fc2_layer(ev, rlk, rtk, sq2, ct_fc2, ct_b2, pt_mask,
                         mask_scale, layout)


def build_fused_inference(params, rlk_set, rtk_set, ct_img, ct_k, ct_fc1,
                          ct_fc2, ct_b1, ct_b2, pt_mask,
                          mask_scale=None, layout: Layout = REF):
    """The whole encrypted inference as one replayable call (fuse.fuse:
    one CUDA graph on the card, eager on the CPU), the counterpart of
    mkhe_tpu/models/cnn.py:300-331.

    Returns (fn, args): fn(*args) runs the full pipeline and returns the
    output mkckks.Ciphertext. To classify a new image, encrypt it and
    substitute args[2][0] (the image ciphertext; args = (ring params, key
    tables, ciphertext tuple)). pt_mask: the fc2 mask plaintext, a tensor
    on the params' device."""
    from .. import fuse as _fuse

    if mask_scale is None:
        mask_scale = params.scale

    def pipe(ev, keys, ct_img, ct_k, ct_fc1, ct_fc2, ct_b1, ct_b2,
             pt_mask):
        return _pipeline(ev, keys.rlk, keys.rtk, ct_img, ct_k, ct_fc1,
                         ct_fc2, ct_b1, ct_b2, pt_mask, mask_scale,
                         layout)

    return _fuse.fuse(
        params, pipe,
        (ct_img, ct_k, ct_fc1, ct_fc2, ct_b1, ct_b2, pt_mask),
        rlk_set=rlk_set, rtk_set=rtk_set)


# ----------------------------------------------------------------------------
# Plaintext reference model
# ----------------------------------------------------------------------------

def plain_forward(image: np.ndarray, kernels, fc1, fc2, b1, b2,
                  layout: Layout = REF):
    lo = layout
    conv = np.zeros((lo.num_kernels, lo.conv_out, lo.conv_out))
    for c in range(lo.num_kernels):
        for i in range(lo.conv_out):
            for j in range(lo.conv_out):
                patch = image[2 * i:2 * i + lo.ksize,
                              2 * j:2 * j + lo.ksize]
                conv[c, i, j] = np.sum(patch * kernels[c])
    x = conv.transpose(1, 2, 0).reshape(-1)   # index i + 5*(j*13+k)
    x = x * x
    x = fc1.T @ x + b1
    x = x * x
    return fc2.T @ x + b2
