"""Declarative per-N parameter registry (port of
`fhe_sorting_tpu/utils/params_registry.py`, the same data).

The table depths are the published ones for 40-bit-scale chains; this
package's chains consume levels at the same rate, so the same numbers apply
as starting points.  The depth a DirectSort needs here comes from the depth
meter (`utils/depth_meter.py`, `measured_direct_sort_depth`).

Sign configs are CompositeSignConfig(n, dg, df).
"""

from __future__ import annotations

# DirectSort: mult_depth per N at scaling-mod 40
DIRECT_SORT_DEPTH = {
    4: 23, 8: 24, 16: 25, 32: 28, 64: 29, 128: 30, 256: 34, 512: 35,
    1024: 39, 2048: 52,
}

# DirectSort hybrid
DIRECT_SORT_HYBRID_DEPTH = {
    4: 24, 8: 25, 16: 26, 32: 29, 64: 30, 128: 31, 256: 35, 512: 43,
    1024: 46, 2048: 50,
}

# MEHP24
MEHP24_DEPTH = {
    4: 31, 8: 34, 16: 36, 32: 39, 64: 41, 128: 44, 256: 46, 512: 51,
    1024: 58, 2048: 64,
}

# MEHP24 indicator iteration counts: dg_i = (log2 N + 1) // 2, df_i = 2
def mehp24_indicator_cfg(n: int):
    return max(2, (n.bit_length() - 1 + 1) // 2), 2


# k-way: N -> (k, M, d_f, d_g)
KWAY_CONFIG = {
    4: (2, 2, 2, 2), 8: (2, 3, 2, 2), 16: (2, 4, 2, 3), 32: (2, 5, 2, 3),
    64: (2, 6, 2, 4), 128: (2, 7, 2, 4), 256: (2, 8, 2, 4),
    512: (2, 9, 2, 5), 1024: (2, 10, 2, 5),
    9: (3, 2, 2, 2), 27: (3, 3, 2, 3), 81: (3, 4, 2, 4), 243: (3, 5, 2, 4),
    729: (3, 6, 2, 5), 2187: (3, 7, 2, 5),
    25: (5, 2, 2, 3), 125: (5, 3, 2, 4), 625: (5, 4, 2, 5),
}

# k-way crypto params: multDepth 40, bootstrap budget
KWAY_MULT_DEPTH = 40

# Serving default: CompositeSignConfig(4, 3, 3)
SERVING_SIGN = (4, 3, 3)


def direct_sort_sign_cfg(n: int):
    """Sign iteration counts that resolve the 1/N input gap.

    CompositeSign<3> iterations (3 levels each) are depth-cheaper than the
    reference serving default (4,3,3) at equal resolved gap:
    g_3 grows a 1/N input by ~4.48x per iteration, so dg must satisfy
    4.48^dg / N >= ~0.6 before f_3 polishing; float-sim worst-case compare
    error over [1/N, 1] is < 1e-7 for every row below, and each shaves
    ~20 levels off the (4,3,3) DirectSort depth (63 -> 42 at N=128)."""
    if n <= 16:
        return (3, 3, 2)
    if n <= 128:
        return (3, 4, 2)
    if n <= 512:
        return (3, 5, 2)
    return (3, 6, 2)


def measured_direct_sort_depth(n: int, ring_n: int, sign_cfg=None) -> int:
    """Computed depth for THIS implementation (stretched sinc fit etc.) via
    the metadata-only depth meter - the live replacement for the reference
    table above; see utils/depth_meter.py."""
    from .depth_meter import measure_direct_sort_depth

    return measure_direct_sort_depth(n, ring_n, sign_cfg)["mult_depth"]
