"""CKKS canonical-embedding encode/decode and CRT, shared with the JAX
package (host numpy only)."""

from fhe_sorting_tpu.core.encoding import (  # noqa: F401
    coeffs_to_residues, crt_to_float_centered, decode_coeffs, encode_coeffs,
)
