"""The staged hybrid DirectSort over `tile`-wide tiles (`parallel/hybrid_staged.StagedHybridSort`): constructRank, then rotationIndexCheckHybrid.

Configuration keys: `n` values, `tile` the reference's maxArraySize, `sign`
constructRank's CompositeSign (n, dg, df), `indicator_dg` the dg of the
placement's sign indicator, and `graphs` (as for the DirectSort).  The key
set is `hybrid_rotation_indices(n, ring, tile)`: constructRank's scan keys
and the placement's basis, made once and held together.  The sort's two
phases each run under a span of the harness, `hybrid.rank` and
`hybrid.place`.  The input holds the values in its n slots.
"""

from __future__ import annotations


def rotation_steps(config: dict, ring_n: int) -> list:
    from fhe_sorting_tpu_torch.parallel.hybrid_staged import hybrid_rotation_indices

    return sorted(hybrid_rotation_indices(config["n"], ring_n, config["tile"]))


class Sort:
    def __init__(self, ev, config: dict):
        from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
        from fhe_sorting_tpu_torch.parallel.hybrid_staged import StagedHybridSort

        cfg = SignConfig(CompositeSignConfig(*config["sign"]))
        self.srt = StagedHybridSort(ev, config["n"], cfg, max_array=config["tile"],
                                    indicator_dg=config["indicator_dg"],
                                    graphs=config.get("graphs"))
        self.stages = self.srt.stages
        self.slots = config["n"]

    def __call__(self, ct, span):
        with span("hybrid.rank"):
            rank = self.srt.base.construct_rank(ct)
        with span("hybrid.place"):
            return self.srt.place(rank, ct)
