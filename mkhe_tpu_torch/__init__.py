"""mkhe_tpu_torch: the PyTorch / CUDA port of mkhe_tpu.

The same multi-key HE schemes (KKLSS MKCKKS and MKBFV) as the JAX package
beside it, with the same data layout and the same Montgomery-form
conventions, so keys, CRS and ciphertexts carry across bit for bit (see
convert.py):

  - polynomials are torch.int64 tensors holding u32 representatives in
    [0, 2^32), shape (..., L, N); NTT-domain data is in bit-reversed order
    (slot j holds the evaluation at psi^(2*brv(j)+1));
  - plain tensor code is PyTorch; the negacyclic NTT/iNTT are hand-written
    CUDA kernels (csrc/ntt.cu, and the split form with an int8
    tensor-core tail in csrc/ntt_split.cu, config.ntt_mxu_tail) on a CUDA
    tensor, and their plain PyTorch versions on a CPU tensor
    (ops/ntt_cuda.py).

Layout mirrors mkhe_tpu:
  ops/      ring arithmetic, NTT kernels, basis conversion, samplers
  mkrlwe/   multi-key RLWE core (keys, key switching, MulAndRelin)
  mkckks/   multi-key CKKS (encoder, encryptor, evaluator)
  mkbfv/    multi-key BFV (double basis, exact encoder, evaluator)
  models/   the two-party encrypted CNN
  fuse      a whole pipeline captured as one CUDA graph (fuse,
            fuse_chained), the JAX package's one-XLA-program runtime tier

This package imports neither JAX nor any module of mkhe_tpu: the host
helpers it needs (prime search, the security table, the decode CRTs) are
copied in, so it runs on a machine that has no JAX.
"""

__version__ = "0.1.0"

from . import fuse  # noqa: E402  (the runtime tier: fuse.fuse, fuse_chained)
