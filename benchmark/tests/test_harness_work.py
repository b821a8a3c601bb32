"""The work counts (mfu_pct's numerator) and the launch bounds (the
rooflines') come from sizes, not from the implementation."""

from __future__ import annotations

import re

import numpy as np
import pytest

from benchmark import cells, readers
from benchmark.work import bounds, counts, peaks


def test_peaks():
    assert abs(peaks.MUL32_PER_S - 16.73e12) < 0.01e12
    assert (peaks.MUL32_PER_PRODUCT_L, peaks.MUL32_PER_PRODUCT_P) == (264, 152)


def test_counts_come_from_sizes(bench, monkeypatch):
    """The counts do not move when every kernel entry is swapped for its
    plain version: they never look at what was launched."""
    conv = cells.config(bench, "conv3")
    cnn = cells.config(bench, "cnn_a")
    dec = [np.full((32, 32), 5e5), np.full(64, 3e8), np.full(16, 6e10),
           np.full(10, 5e10)]
    wf = {k: np.ones(s, dtype=np.int64) for k, s in (
        ("weight_fc1", (64, 16)), ("bias_fc1", (16,)),
        ("weight_fc2", (16, 10)), ("bias_fc2", (10,)))}

    def all_counts():
        return (counts.serve_conv(conv, 256), counts.serve_cnn(cnn, 32, wf, dec),
                counts.prove(conv["proofs"]["add"]["r1cs"], True, "add", 16, 0),
                counts.prove(conv["proofs"]["mult"]["r1cs"], False, "mult",
                             18, 128))

    before = all_counts()
    from vpin_tpu_torch.curve import cuda_ec, cuda_edwards
    from vpin_tpu_torch.field import cuda_mont, prime_field
    monkeypatch.setattr(prime_field, "mont_mul", cuda_mont.mont_mul_plain)
    monkeypatch.setattr(prime_field, "mont_pow", cuda_mont.mont_pow_plain)
    monkeypatch.setattr(cuda_ec, "e2_add", cuda_ec.e2_add_plain)
    monkeypatch.setattr(cuda_ec, "e2_scalar_mul", cuda_ec.e2_scalar_mul_plain)
    monkeypatch.setattr(cuda_edwards, "ed_msm", cuda_edwards.ed_msm_plain)
    assert all_counts() == before
    assert all(c > 0 for c in before)


def test_serve_count_matches_a_hand_count(bench):
    """The conv's count, by hand: 67 additions a pixel to encrypt; per half
    and output pixel the 6 weight multiples (1, 1, 2, 2, 1, 1: 8 additions)
    and 8 sums, 1 rho multiple of 128 bits (159) and a sum on the left, 9
    rho multiples and 9 sums on the right."""
    conv = cells.config(bench, "conv3")
    n, M = 4, 4
    per_half = M * (8 + 8) + M * 159 + M - 1 + M * 9 * 159 + 9 * (M - 1) + 8 + 8
    want = (67 * n + 2 * per_half) * 17 * 264
    assert counts.serve_conv(conv, 2) == want


def test_launch_bounds_of_known_shapes():
    """chip_smoke's bounds of three shapes (PERF.md's kernel table): K1 at
    2^21 products mod l, 0.0601 ms by bytes; ed_table on 2,049 columns,
    0.0427 ms; ed_msm of 1,024 rows x 2,049 points, 5.5125 ms by
    operations."""
    import torch

    class F:
        modulus = peaks.L_MODULUS

    log = bounds.LaunchLog()
    log._record("mont_mul", (torch.zeros(1 << 21, 8), torch.zeros(1, 8), F()))
    pts = tuple(torch.zeros(2049, 8) for _ in range(4))
    log._record("ed_table", (None, pts))
    log._record("ed_msm", (None, pts, torch.zeros(1024, 2049, 32)))
    b = log.bounds()
    assert abs(b["mont_mul"] * 1e3 - 0.0601) < 0.0001
    assert abs(b["ed_table"] * 1e3 - 0.0427) < 0.0001
    assert abs(b["ed_msm"] * 1e3 - 5.5125) < 0.001


def test_ladder_bound_counts_set_bits():
    import torch
    words = torch.tensor([[0b1011, 0, 0, 0]], dtype=torch.int32)
    # three ladders on the one row: 3 set bits and 3 doublings each
    assert bounds._ladder_adds(words, 3, 4, 3, 1) == 3 * 3 + 3 * 3


def test_every_port_kernel_has_an_entry():
    src = cells.ROOT / "vpin_tpu_torch" / "csrc"
    found = set()
    for path in src.glob("*.cu"):
        found |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s+)?(\w+)", path.read_text()))
    assert found == set(bounds.KERNELS)
    assert bounds.kernel_entry("void e2_scalar_mul_kernel<4>(unsigned int "
                               "const*)") == "e2_scalar_mul"
    assert bounds.kernel_entry("e2_add_kernel(unsigned int const*)") == "e2_add"
    assert bounds.kernel_entry("void at::native::elementwise_kernel<128>") is None


@pytest.mark.parametrize("kind", ["serve", "proof"])
def test_shares_read_nothing_without_a_trace(kind):
    rec = {"kind": kind, "steps": [{"ok": True, "latency_s": 1.0}],
           "window_s": 1.0, "trace": None}
    assert readers.roofline_pct(rec, kind) is None
    assert readers.idle_pct(rec, kind) is None
    assert readers.launches(rec, kind) is None
    assert readers.mfu_pct(rec, kind) is None


def test_shares_from_a_trace():
    rec = {"kind": "serve", "window_s": 2.0,
           "steps": [{"ok": True, "latency_s": 1.0, "work": 1e12},
                     {"ok": True, "latency_s": 1.0, "work": 1e12,
                      "profiled": True}],
           "trace": {"steps": 2, "kernels": 10, "busy_s": 0.5,
                     "window_s": 2.0, "port_s": {"e2_add": 0.2},
                     "bound_s": {"e2_add": 0.05}}}
    assert readers.launches(rec, "serve") == 5
    assert readers.idle_pct(rec, "serve") == 75.0
    assert readers.roofline_pct(rec, "serve") == 25.0
    assert abs(readers.mfu_pct(rec, "serve") - 100 / 16.727) < 0.01
    assert readers.roofline_pct(rec, "proof") is None


def test_idle_gaps_split_over_the_host_spans_open_during_them():
    """A gap from 11 s to 14 s while the host runs a (to 11.5), outer,
    b (12 to 12.5), outer (to 13.5), then nothing: each gets its share."""
    from benchmark.tracing import _busy_and_gaps, _name_gaps
    device = [{"t": 10.0, "dur": 1.0}, {"t": 14.0, "dur": 1.0}]
    busy, gaps = _busy_and_gaps(device)
    assert busy == 2.0 and gaps == [(11.0, 3.0, 1)]
    spans = [{"name": "outer", "t": 10.0, "dur": 3.5},
             {"name": "a", "t": 10.5, "dur": 1.0},
             {"name": "b", "t": 12.0, "dur": 0.5}]
    got = _name_gaps([(s, n) for s, n, _ in gaps], spans)
    assert got == {"a": 0.5, "outer": 1.5, "b": 0.5,
                   "(outside any span)": 0.5}


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", cells.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sumcheck_bounds_equal_chip_smokes():
    """sc_round and sc_bind are bounded as chip_smoke.py's hold_sc_round
    and hold_sc_bind bound them, on PERF.md's shapes: 12 circuits x half
    2,048, cubic, the last table broadcast along the circuits (0.0023 ms by
    operations), and their bind of 3 tables (0.0017 ms by bytes)."""
    import torch
    cs = _chip_smoke()
    K, h = 12, 2048
    stack = torch.zeros(K, 2 * h * 2, 8, dtype=torch.int32)
    eq = torch.zeros(1, 2 * h, 8, dtype=torch.int32).expand(K, 2 * h, 8)
    tabs = [stack[:, :2 * h], stack[:, 2 * h:], eq]
    los = [t[:, :h] for t in tabs]
    his = [t[:, h:] for t in tabs]
    log = bounds.LaunchLog()
    log._record("sc_round", ("cubic", los, his, None))
    log._record("sc_bind", (los, his, 5, None))
    got = log.bounds()
    rate = peaks.MUL32_PER_S
    want_round = cs.bound_ms(cs.SC_PRODUCTS["cubic"] * cs.MUL32_PER_MONT
                             * K * h, cs.sc_bytes([*los, *his]), rate)
    elems = 3 * K * h
    want_bind = cs.bound_ms(cs.MUL32_PER_MONT * elems,
                            cs.sc_bytes([*los, *his]) + 32 * elems, rate)
    assert got["sc_round"] * 1e3 == pytest.approx(want_round[0], rel=1e-12)
    assert got["sc_bind"] * 1e3 == pytest.approx(want_bind[0], rel=1e-12)
    assert want_round[1] == "operations" and want_bind[1] == "bytes"
    assert abs(got["sc_round"] * 1e3 - 0.0023) < 0.0001
    assert abs(got["sc_bind"] * 1e3 - 0.0017) < 0.0001
    assert bounds.SC_PRODUCTS == cs.SC_PRODUCTS
    for name in ("sc_round_kernel", "sc_round_reduce_kernel"):
        assert bounds.kernel_entry(f"{name}(long long const*)") == "sc_round"
    assert bounds.kernel_entry("sc_bind_kernel(long long const*)") == "sc_bind"
