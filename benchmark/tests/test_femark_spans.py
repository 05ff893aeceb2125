"""The readers of the port's spans (``vcycle_share``, ``coarse_share``,
``transfer_share``, ``dot_share``, ``sync_wait_share``): silent without
spans, shares in [0, 1] on a traced CPU run of each solve cell at a small
size, and, on the card, port spans that stay off the device's timeline."""

import sys

import pytest
import torch

from arcanefem_tpu_torch.utils import tracing
from benchmark import core, port_spans, run

READERS = ("vcycle_share", "coarse_share", "transfer_share", "dot_share", "sync_wait_share")
SMALL = {"sphere-1.9m.amg-pcg": {"mesh": {"h": 14, "refine": 0}},
         "box-224-r0.mg-pcg": {"mesh": {"n": 16, "jitter": 0.1}}}
SEED = 2**31 + 23


def reader(name):
    return core.module("metrics", name).read


def test_readers_are_silent_without_spans(monkeypatch):
    tracing.reset()
    for name in READERS:
        assert reader(name)({}) is None
    # a port without the tracing module (the import fails): no report
    monkeypatch.setitem(sys.modules, "arcanefem_tpu_torch.utils.tracing", None)
    assert port_spans.report() == {}
    for name in READERS:
        assert reader(name)({}) is None


def test_level_names():
    assert port_spans.level_of("vcycle.l12.prolong") == 12
    for name in ("vcycle", "vcycle.coarse", "cg.dot", "vcycle.lx.smooth"):
        assert port_spans.level_of(name) is None


@pytest.mark.parametrize("cell", list(SMALL))
def test_shares_on_a_traced_cpu_run(cell):
    tracing.reset()
    result, _ = run.run(cell, SEED, 0.2, True, device="cpu", plain=True, mesh_cache=False,
                        config_overrides=SMALL[cell])
    assert result["correct"] is True
    got = {name: result["metrics"][name]["value"] for name in READERS}
    assert all(0.0 <= v <= 1.0 for v in got.values()), got
    assert got["vcycle_share"] + got["dot_share"] <= 1.0
    assert got["coarse_share"] > 0.0 and got["transfer_share"] > 0.0
    # with the profiler off the window recorded nothing: a --trace 0 run
    tracing.reset()
    result, _ = run.run(cell, SEED, 0.2, False, device="cpu", plain=True, mesh_cache=False,
                        config_overrides=SMALL[cell])
    assert tracing.report() == {} and result["correct"] is True


@pytest.mark.card
def test_port_spans_stay_off_the_device_timeline(cuda):
    """One traced sphere load case at the cell's size: no device-typed
    event carries a port span's name."""
    from torch.profiler import ProfilerActivity, profile

    cell = "sphere-1.9m.amg-pcg"
    _, config, mix = core.cell(cell)
    system = core.module("systems", config["system"]).System(
        config, mix, cuda, mesh_cache=False, spans={})
    system.case({"f": 1.0, "g": 1.0})
    system.sync()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        system.case({"f": 1.0, "g": 1.0})
        system.sync()
    names = set(tracing.report())
    assert {"cg", "vcycle", "cg.dot", "vcycle.coarse"} <= names
    cuda_events = {e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
    assert cuda_events and not names & cuda_events
