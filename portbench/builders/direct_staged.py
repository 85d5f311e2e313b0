"""The staged DirectSort (`parallel/direct_staged.StagedDirectSort`): constructRank, then rotationIndexCheck.

Configuration keys: `n` values, `sign` the CompositeSign (n, dg, df), and
`graphs` (true: CUDA graphs, as on the card by default; null: the
program's default for the device).  The key set is the minimal scan set.
The sort's two phases each run under a span of the harness,
`direct.rank` and `direct.index`.
"""

from __future__ import annotations


def rotation_steps(config: dict, ring_n: int) -> list:
    from fhe_sorting_tpu_torch.parallel.direct_staged import scan_rotation_indices

    return sorted(scan_rotation_indices(config["n"], ring_n))


class Sort:
    def __init__(self, ev, config: dict):
        from fhe_sorting_tpu_torch.ops.sign import CompositeSignConfig, SignConfig
        from fhe_sorting_tpu_torch.parallel.direct_staged import StagedDirectSort

        cfg = SignConfig(CompositeSignConfig(*config["sign"]))
        self.srt = StagedDirectSort(ev, config["n"], cfg, graphs=config.get("graphs"))
        self.stages = self.srt.stages
        self.slots = config["n"]

    def __call__(self, ct, span):
        with span("direct.rank"):
            rank = self.srt.construct_rank(ct)
        with span("direct.index"):
            return self.srt.index_check(rank, ct)
