"""fhe_sorting_tpu_torch: the RNS-CKKS sorting runtime in PyTorch for CUDA.

A port of `fhe_sorting_tpu` (JAX/Pallas) that keeps its algorithms and its
exact integer semantics: given the same keys, ciphertexts and tables, every
operation returns bit-identical limb planes.  Residues are held as int64
tensors (every prime is below 2^31, so a product fits in 63 bits).  Both
NTTs run as hand-written CUDA kernels for tensors on a GPU (the four-step
NTT `csrc/fs_ntt.cu`, the butterfly NTT `csrc/bf_ntt.cu`) and as plain
PyTorch for tensors on the CPU.  Entry points run on the first CUDA card
unless the caller asks for the CPU (`Context(params, device="cpu")`).

Layout (mirrors `fhe_sorting_tpu`):
  core/      CKKS runtime: modular arithmetic, NTTs, context, keys, evaluator
  ops/       sign, comparison, Chebyshev evaluation, the rotation engine
  models/    DirectSort (per-op), its mask generators and rotation sets
  parallel/  the staged DirectSort
  utils/     sinc coefficients, parameter registry, depth meter, profiler run
  csrc/      CUDA sources, built at first use into `_build/`
"""

__version__ = "0.1.0"
