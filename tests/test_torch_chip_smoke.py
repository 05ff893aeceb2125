"""chip_smoke.py's device-time reading, on the CPU: the kernels it looks
for in each CUDA source, and the rule that reads a kernel's events out of
a profiler trace (only the record's own kernels, the median, None where
too few or too many were traced)."""

import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "arcanefem_tpu_torch", "csrc")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("src", sorted(f for f in os.listdir(CSRC) if f.endswith(".cu")))
def test_kernel_names_cover_every_global(src):
    with open(os.path.join(CSRC, src)) as fh:
        text = fh.read()
    names = _smoke()._kernel_names(src)
    assert len(names) == text.count("__global__")
    assert len(set(names)) == len(names)
    for name in names:
        assert re.search(rf"\b{name}\s*\(", text), name


def _events(own_us, stray_us=()):
    """A trace as the profiler names kernels: demangled, with templates."""
    own = [("void (anonymous namespace)::stencil_assembly_kernel<float>(float const*, "
            "float const*, float const*, float*, float*, int, int, int, int, int, int, "
            "long, long, float, float)", us) for us in own_us]
    stray = [("void at::native::vectorized_elementwise_kernel<4, "
              "at::native::FillFunctor<float>>(int, ...)", us) for us in stray_us]
    return own + stray


def test_own_events_ms_reads_only_the_records_kernels():
    own = _smoke()._own_events_ms
    names = ("stencil_assembly_kernel",)
    ms, counts = own(_events([540.0] * 15 + [560.0] * 5, [9000.0] * 30), names, 20)
    assert ms == pytest.approx(0.54) and counts == [20, 20]
    # a name that only contains the kernel's name is another kernel
    ms, counts = own([("void (anonymous namespace)::sell_spmv_batched_kernel<float>()",
                       180.0)] * 20, ("sell_spmv_kernel",), 20)
    assert ms is None and counts == [0, 20]


def test_own_events_ms_is_none_when_the_trace_is_short_or_doubled():
    own = _smoke()._own_events_ms
    names = ("stencil_assembly_kernel",)
    assert own(_events([540.0] * 10), names, 20) == (0.54, [10, 20])
    assert own(_events([540.0] * 9), names, 20) == (None, [9, 20])
    assert own(_events([540.0] * 39), names, 20)[0] == pytest.approx(0.54)
    assert own(_events([540.0] * 40), names, 20) == (None, [40, 20])
    assert own([], names, 20) == (None, [0, 20])
