"""A cell cut to CPU sizes, for the tests: images of 4 pixels a side, a
2-add or 2-mult witness, a small BSGS table."""

from __future__ import annotations

import copy


def small(bench, cell: str, **mix):
    """(config, mix) of ``cell`` cut to CPU sizes: images of 4 or 8
    pixels, a 2-add or 2-mult witness, a small BSGS table."""
    from benchmark import cells
    c = cells.cell(bench, cell)
    cfg = copy.deepcopy(cells.config(bench, c["config"]))
    mx = copy.deepcopy(cells.mix(c["traffic"]))
    if cfg["kind"] == "cnn":
        mx.update(size=4, warm_requests=0, check_points=16, check_requests=1)
        cfg.update(fc=[1, 16, 10], bsgs_m=1 << 15, weight_scale=0.001)
    elif mx["driver"] == "serve":
        mx.update(size=4, warm_requests=0, check_points=8, check_requests=1)
    else:
        # the golden fixtures' sizes of the 2-add and 2-mult (128-bit)
        # proofs, which vpin_tpu made (crosscheck/golden)
        mx.update(size=4, traces=1, witness_slice=2)
        cfg["proofs"]["add"]["bytes"]["full"] = 16880
        cfg["proofs"]["mult"]["bytes"]["transparent"] = 11840
    mx.update(mix)
    return cfg, mx


def run_small(bench, cell: str, seed: int = 2 ** 31 + 5, trace=False,
              control=False, config=None, mix=None, **mix_over):
    from benchmark.run import run_cell
    cfg, mx = small(bench, cell, **mix_over)
    return run_cell(bench, cell, seed, 0.01, trace, device="cpu",
                    config=config or cfg, mix=mix or mx, control=control)
