"""NTT-friendly prime generation, shared with the JAX package (numpy and
Python integers only)."""

from fhe_sorting_tpu.core.primes import (  # noqa: F401
    is_prime, ntt_primes, primitive_root_2n,
)
