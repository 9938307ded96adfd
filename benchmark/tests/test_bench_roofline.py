"""The roofline arithmetic copied from chip_smoke.py gives its figures."""

import types

import pytest
import torch

from benchmark import roofline


@pytest.mark.parametrize("mode", [1, 0])
def test_fused_bound_equals_chip_smoke(mode):
    import chip_smoke

    g = torch.Generator().manual_seed(mode)
    n_b, R = 5, 4096
    alive = torch.cumprod((torch.rand((n_b, R), generator=g) < 0.8).int(),
                          0).bool()
    code = (alive.int() * 8).to(torch.int32)       # the alive bit
    live = [R] + [int(a.sum()) for a in alive[:-1]]
    scene = types.SimpleNamespace(n_tri=26,
                                  fused_profile=(1, False, False, 8, mode))
    want = chip_smoke.fused_bound(scene, code)
    got = roofline.bound_ms(*roofline.fused_counts(R, 26, live, mode))
    assert got == want


@pytest.mark.parametrize("n_bytes,n_ops", [(1e9, 1e12), (3.35e12, 1.0),
                                           (0.0, 67e12)])
def test_bound_ms_equals_chip_smoke(n_bytes, n_ops):
    import chip_smoke

    assert roofline.bound_ms(n_bytes, n_ops) == chip_smoke.bound_ms(n_bytes,
                                                                    n_ops)


def test_peaks_are_the_data_sheets():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_FP32_PER_S == 67e12
    assert (roofline.OPS_TRI, roofline.OPS_PLN) == (46, 8)


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def test_fused_roofline_reads_the_counted_passes():
    """Launch i is pass i, in the trace's time order; launches past the
    passes counted are left out."""
    from benchmark import spec

    counts = [{"lanes": 4096, "n_tri": 26, "live": [4096, 3000, 2000, 900,
                                                    400]},
              {"lanes": 4096, "n_tri": 26, "live": [4096, 2900, 1900, 800,
                                                    300]}]
    events = [_kernel("fused_path_kernel<1>", 300, 50.0),
              _kernel("fused_path_kernel<1>", 100, 40.0),
              _kernel("fused_path_kernel<1>", 200, 60.0),
              _kernel("elementwise", 150, 5.0)]
    rec = {"events": events, "pass_counts": counts,
           "config": {"roofline": {"kernel": "fused_path_kernel",
                                   "mode": 1}}}
    want = sum(roofline.bound_ms(*roofline.fused_counts(
        c["lanes"], c["n_tri"], c["live"], 1))[0] for c in counts)
    got = spec.reader("fused_roofline_pct")(rec)
    assert got == pytest.approx(100.0 * want / 0.100)
    rec["pass_counts"] = counts * 2
    assert spec.reader("fused_roofline_pct")(rec) is None


def test_collective_ms_counts_from_the_last_arrival():
    """Each collective's least duration over the ranks, summed over the
    traced steps' collectives, a step."""
    from benchmark import spec

    rec = {"trace_iters": 2,
           "step_kernel_us": {"nccl": [[900.0, 50.0, 700.0, 40.0],
                                       [100.0, 400.0, 90.0, 30.0],
                                       [120.0, 45.0, 95.0, 600.0],
                                       [800.0, 60.0, 85.0, 35.0]]}}
    got = spec.reader("collective_ms")(rec)
    assert got == pytest.approx(1e-3 * (100 + 45 + 85 + 30) / 2)
    rec["step_kernel_us"]["nccl"][2].pop()
    assert spec.reader("collective_ms")(rec) is None
