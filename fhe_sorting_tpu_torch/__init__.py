"""fhe_sorting_tpu_torch: the RNS-CKKS sorting runtime in PyTorch for CUDA.

A port of `fhe_sorting_tpu` (JAX/Pallas) that keeps its algorithms and its
exact integer semantics: given the same keys, ciphertexts and tables, every
operation returns bit-identical limb planes.  Residues are held as int64
tensors (every prime is below 2^31, so a product fits in 63 bits).  The
four-step NTT runs as a hand-written CUDA kernel (`csrc/fs_ntt.cu`) for
tensors on a GPU and as plain PyTorch for tensors on the CPU.

Layout (mirrors `fhe_sorting_tpu`):
  core/      CKKS runtime: modular arithmetic, NTTs, context, keys, evaluator
  ops/       sign and Chebyshev polynomial evaluation
  models/    DirectSort mask generators and rotation sets
  parallel/  the staged DirectSort
  utils/     sinc coefficients, parameter registry, depth meter
  csrc/      CUDA sources, built at first use into `_build/`
"""

__version__ = "0.1.0"
