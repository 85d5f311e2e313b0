"""ctypes loader of the native host kernels (`native/fhe_host.cpp`), shared
with the JAX package."""

from fhe_sorting_tpu.core.native import (  # noqa: F401
    available, intt_batch, ntt_batch,
)
