"""Per-N DirectSort sign parameters (port of the DirectSort part of
`fhe_sorting_tpu/utils/params_registry.py`).  The depth a sort needs comes
from the depth meter (`utils/depth_meter.py`).

Sign configs are CompositeSignConfig(n, dg, df).
"""

from __future__ import annotations

def direct_sort_sign_cfg(n: int):
    """CompositeSign<3> iteration counts that resolve the 1/N input gap:
    g_3 grows a 1/N input by ~4.48x per iteration, so dg must satisfy
    4.48^dg / N >= ~0.6 before f_3 polishing."""
    if n <= 16:
        return (3, 3, 2)
    if n <= 128:
        return (3, 4, 2)
    if n <= 512:
        return (3, 5, 2)
    return (3, 6, 2)
