"""The port's open-loop load harness (``ray_tpu_torch.llm.loadgen``),
mirroring ``tests/test_llm_loadgen.py``: the schedule math that makes the
harness open-loop and the client-side summary, against the reference's
numbers where both compute them. The served path (``run_curve`` through
the HTTP proxy into a replica) is held in ``tests/test_torch_serve_llm.py``
and on the card by ``chip_smoke.py``. No cluster here.
"""

from ray_tpu_torch.llm import loadgen


def test_constant_curve_spacing():
    offs = loadgen.arrivals("constant", rate=10.0, duration_s=2.0)
    assert len(offs) == 20
    gaps = [b - a for a, b in zip(offs, offs[1:])]
    assert all(abs(g - 0.1) < 1e-9 for g in gaps)


def test_poisson_curve_seeded_and_bounded():
    a = loadgen.arrivals("poisson", rate=50.0, duration_s=4.0, seed=7)
    b = loadgen.arrivals("poisson", rate=50.0, duration_s=4.0, seed=7)
    c = loadgen.arrivals("poisson", rate=50.0, duration_s=4.0, seed=8)
    assert a == b  # reproducible schedules: same run is the same run
    assert a != c
    assert all(0.0 <= t < 4.0 for t in a)
    assert a == sorted(a)
    # law of large numbers, generous: ~200 expected
    assert 120 < len(a) < 300


def test_ramp_curve_densifies():
    offs = loadgen.arrivals("ramp", rate=5.0, duration_s=10.0, ramp_to=50.0)
    assert offs == sorted(offs)
    assert all(0.0 <= t <= 10.0 for t in offs)
    first_half = sum(1 for t in offs if t < 5.0)
    second_half = len(offs) - first_half
    # the rate grows: the back half must carry well more arrivals
    assert second_half > first_half * 1.5


def test_burst_curve_clump():
    offs = loadgen.arrivals("burst", rate=2.0, duration_s=4.0, burst_n=30)
    assert offs == sorted(offs)
    assert sum(1 for t in offs if t == 2.0) >= 30  # the clump, together


def test_unknown_curve_rejected():
    import pytest

    with pytest.raises(ValueError):
        loadgen.arrivals("sawtooth", rate=1.0, duration_s=1.0)


def test_empty_curves():
    assert loadgen.arrivals("constant", rate=0.0, duration_s=5.0) == []
    assert loadgen.arrivals("poisson", rate=10.0, duration_s=0.0) == []


def test_summarize_client_status_mix():
    recs = (
        [{"status": 200, "e2e_s": 0.1 * i, "ttft_s": 0.01} for i in range(1, 5)]
        + [{"status": 429, "e2e_s": 0.01} for _ in range(4)]
        + [{"status": 0, "error": "ConnectionError", "e2e_s": 0.0}]
    )
    s = loadgen.summarize_client(recs, duration_s=2.0)
    assert s["requests"] == 9 and s["ok"] == 4 and s["errors"] == 1
    assert s["shed_429"] == 4
    assert abs(s["shed_rate"] - 4 / 9) < 1e-3  # rounded to 4 decimals
    assert s["offered_rate_rps"] == 4.5
    # percentiles come from the SUCCESSFUL streams only — shed 429s must
    # not dilute the latency distribution they were shed to protect
    assert s["e2e_s"]["count"] == 4
    assert s["e2e_s"]["p50"] in (0.2, 0.3)
    assert s["ttft_s"]["count"] == 4


def test_curves_and_summary_equal_the_reference():
    """The port's arrival curves and client summary are the reference's,
    number for number."""
    from ray_tpu.llm import loadgen as ref

    for curve, kw in (("constant", {}), ("poisson", {"seed": 3}),
                      ("ramp", {"ramp_to": 40.0}), ("burst", {"burst_n": 7})):
        assert loadgen.arrivals(curve, 12.0, 3.0, **kw) == ref.arrivals(curve, 12.0, 3.0, **kw)
    recs = [{"status": 200, "e2e_s": 0.05 * i, "ttft_s": 0.01 * i} for i in range(1, 9)]
    recs += [{"status": 429, "e2e_s": 0.01}, {"status": 500, "e2e_s": 0.2}]
    assert loadgen.summarize_client(recs, 1.7) == ref.summarize_client(recs, 1.7)
