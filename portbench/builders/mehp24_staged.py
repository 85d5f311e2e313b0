"""The staged MEHP24 triangle sort over sub x sub tiles (`parallel/mehp24_staged.StagedMehp24Multi`).

Configuration keys: `n` values, `sub` the tile's sub-length, `sign` the
(dg_c, df_c, dg_i, df_i) of its comparisons and indicators, and `graphs`
(as for the DirectSort).  The key set is `mehp24_staged_keys(sub, ring)`.
The input holds the values in the first `n` of sub * sub slots.
"""

from __future__ import annotations


def rotation_steps(config: dict, ring_n: int) -> list:
    from fhe_sorting_tpu_torch.parallel.mehp24_staged import mehp24_staged_keys

    return sorted(mehp24_staged_keys(config["sub"], ring_n))


class Sort:
    def __init__(self, ev, config: dict):
        from fhe_sorting_tpu_torch.parallel.mehp24_staged import StagedMehp24Multi

        self.srt = StagedMehp24Multi(ev, config["n"], config["sub"], *config["sign"],
                                     graphs=config.get("graphs"))
        self.stages = self.srt.stages
        self.slots = config["sub"] ** 2

    def __call__(self, ct, span):
        return self.srt(ct)
