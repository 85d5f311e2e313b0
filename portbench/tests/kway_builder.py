"""A test-only builder: the k-way sorting network with real refreshes (`models/kway/sorter.KWaySorter`).

Configuration keys: `n` values (a power of `k`), `k` the network's arity,
`sign` the CompositeSign (n, dg, df) of its comparisons, and `refresh` the
bootstrap's shape (`K`, `sin_degree`, `double_angle`, `asin_terms`,
`level_budget`).  Every rotation, the refresh's among them, goes through
one `RotationComposer` over the signed power-of-two basis with no lazy key
pool, so no key is made inside a sort.  A refresh conjugates
(CoeffsToSlots), so the module asks for the conjugation key.  The sort runs
eagerly: its stage table stays empty.  `fired` counts the refreshes of each
sort.
"""

from __future__ import annotations

import math

CONJUGATION_KEY = True


def _basis(ring_n: int) -> list:
    """Positive powers of two below a quarter of the ring, and -1, -2, -4, -8."""
    return sorted({1 << i for i in range(ring_n.bit_length() - 2)} | {-(1 << i) for i in range(4)})


def rotation_steps(config: dict, ring_n: int) -> list:
    from fhe_sorting_tpu_torch.models.kway.sorter import rotation_indices_kway

    return sorted(set(_basis(ring_n)) | rotation_indices_kway(1 << (config["n"] - 1).bit_length()))


class Sort:
    def __init__(self, ev, config: dict):
        from fhe_sorting_tpu_torch.core.bootstrap import Bootstrapper
        from fhe_sorting_tpu_torch.models.kway.sorter import KWaySorter
        from fhe_sorting_tpu_torch.ops.rotation import RotationComposer
        from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
        from fhe_sorting_tpu_torch.parallel.whole_graph import StageTable

        k, n = config["k"], config["n"]
        M = round(math.log(n, k))
        assert k ** M == n, (k, n)
        shape = dict(config["refresh"])
        shape["level_budget"] = tuple(shape["level_budget"])
        rot = RotationComposer(ev, _basis(ev.ctx.params.ring_n), lazy_key_budget=None)
        self.bs = Bootstrapper(ev, rot=rot, **shape)
        self.srt = KWaySorter(ev, k, M, bootstrap_fn=self._refresh, rot=rot)
        self.cfg = SignConfig(CompositeSignConfig(*config["sign"]),
                              mult_depth=ev.ctx.params.mult_depth)
        self.stages = StageTable(ev, graphs=False, prefix="kway")
        self.slots = self.srt.num_slots
        self.fired = []

    def _refresh(self, ct):
        self.fired[-1] += 1
        return self.bs.bootstrap(ct)

    def __call__(self, ct, span):
        from fhe_sorting_tpu_torch.ops.sign import SignFunc

        self.fired.append(0)
        return self.srt.sort(ct, SignFunc.CompositeSign, self.cfg)
