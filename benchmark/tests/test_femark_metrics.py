"""The arithmetic of the metric readers, on synthetic windows and traces."""

import pytest

from benchmark import core, trace


def reader(name):
    return core.module("metrics", name).read


def closed(ms, window_s=None, **extra):
    cases = [{"ms": m, "iterations": 10, "rel": 1e-9, **extra} for m in ms]
    return {"kind": "closed_loop", "window_s": window_s or sum(ms) / 1e3,
            "units": len(ms), "failed": 0, "cases": cases}


def test_rate_is_all_work_over_the_window():
    ctx = {"window": closed([10.0] * 100, window_s=1.2)}  # 0.2 s outside the cases
    assert reader("solve_ms")(ctx) == pytest.approx(12.0)
    stream = {"kind": "stream", "window_s": 2.0, "units": 3000, "cases": []}
    assert reader("assembly_mdofs")({"window": stream, "n_dofs": 1_000_000}) == \
        pytest.approx(1500.0)


def test_p95_is_over_all_cases():
    ms = list(range(1, 101))  # 1..100 ms
    assert reader("solve_p95_ms")({"window": closed(ms)}) == pytest.approx(95.05)
    assert core.p95([5.0]) == 5.0


def test_an_injected_stall_moves_solve_ms_and_its_p95():
    base = [50.0] * 200
    stalled = base[:]
    for i in range(0, 200, 10):  # every tenth case waits 40 ms more
        stalled[i] += 40.0
    a, b = {"window": closed(base)}, {"window": closed(stalled)}
    assert reader("solve_ms")(b) == pytest.approx(reader("solve_ms")(a) + 4.0)
    assert reader("solve_p95_ms")(b) == pytest.approx(90.0)
    assert reader("solve_p95_ms")(a) == pytest.approx(50.0)


def test_idle_share_on_a_synthetic_timeline():
    # kernels busy 0-40 and 30-60 us (overlap), 100-150; a stall 150-400
    dev = [(0.0, 40.0, "k1"), (30.0, 60.0, "k2"), (100.0, 150.0, "k1")]
    host = [(55.0, 120.0, "aten::mul"), (0.0, 500.0, "pcg"), (150.0, 420.0, "aten::item")]
    summary, breakdown = trace.summarise(dev, host, 500e-6, 2, {"pcg"})
    assert summary["busy_s"] == pytest.approx(110e-6)
    ctx = {"window": closed([1.0]), "trace": summary}
    assert reader("idle_share.solve")(ctx) == pytest.approx(1 - 110 / 500)
    assert reader("idle_share.assembly")(ctx) is None
    assert dict(breakdown["device_ops"])["k1"] == pytest.approx(90e-6)
    assert breakdown["idle_gaps"] == [["pcg/aten::mul", pytest.approx(40e-6)]]
    stalled, _ = trace.summarise(dev + [(400.0, 450.0, "k3")], host, 500e-6, 2, {"pcg"})
    assert stalled["busy_s"] == pytest.approx(160e-6)


def test_span_annotations_are_not_device_work():
    dev = [(0.0, 10.0, "k")]
    host = [(0.0, 100.0, "case")]
    summary, _ = trace.summarise(dev, host, 100e-6, 1, {"case"})
    assert core.idle_share(summary) == pytest.approx(0.9)


def test_readers_stay_silent_without_their_data():
    stream = {"kind": "stream", "window_s": 1.0, "units": 10, "cases": []}
    for name in ("solve_ms", "solve_p95_ms", "iterations", "ms_per_iter", "pre_solve_ms",
                 "launches_per_case", "idle_share.solve"):
        assert reader(name)({"window": stream, "trace": None, "launches": {}}) is None
    assert reader("asm_roofline")({"window": stream, "trace": None}) is None
    assert reader("amg_setup_s")({"spans": {}}) is None


def test_event_metrics_use_all_cases():
    w = closed([10.0, 10.0])
    w["cases"][0].update(pre_ms=1.0, cg_ms=20.0)
    w["cases"][1].update(pre_ms=3.0, cg_ms=10.0, iterations=20)
    ctx = {"window": w, "launches": {"sell_spmv": 100, "slot_reduce": 2}}
    assert reader("ms_per_iter")(ctx) == pytest.approx(30.0 / 30)
    assert reader("pre_solve_ms")(ctx) == pytest.approx(2.0)
    assert reader("iterations")(ctx) == pytest.approx(15.0)
    assert reader("launches_per_case")(ctx) == pytest.approx(51.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert core.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert core.spread([9.0, 10.0, 10.0, 11.0]) > 0
