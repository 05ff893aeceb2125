"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port either (top-level names compared
whole: ``arcanefem_tpu_torch`` is not ``arcanefem_tpu``)."""

import json
import subprocess
import sys

from benchmark import core

LOAD_ALL = """
import json, sys
from benchmark import core, run, control, trace, roofline
for kind in ("systems", "traffic", "metrics"):
    for name in core.names(kind, ".py"):
        core.module(kind, name)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import json, sys
import benchmark.reference.p1_tetra, benchmark.reference.kuhn_box, benchmark.reference.compare
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _tops(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_imports_no_jax():
    tops = _tops(LOAD_ALL)
    assert "arcanefem_tpu_torch" in tops  # the port is what it measures
    assert not tops & {"jax", "jaxlib", "flax", "arcanefem_tpu", "bench"}


def test_the_reference_imports_neither_package():
    tops = _tops(LOAD_REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "arcanefem_tpu", "arcanefem_tpu_torch"}


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules({"arcanefem_tpu_torch.sparse": 1, "jaxtyping": 1}) == []
    assert core.forbidden_modules({"arcanefem_tpu.mesh": 1, "jax.numpy": 1}) == \
        ["arcanefem_tpu", "jax"]
