"""The gather probes (arcanefem_tpu_torch/tools/probe_gather.py, the
counterpart of the JAX package's tools/probe_gather.py P1-P3): the plain
twins of the window take against numpy, on the CPU."""

import numpy as np
import pytest
import torch

from arcanefem_tpu_torch.tools.probe_gather import (
    probe_A,
    probe_B,
    window_take,
)


@pytest.mark.parametrize("K,G", [(160, 64), (1024, 64), (8, 3)])
def test_probes_match_numpy(K, G):
    assert probe_A(K, G, "cpu") and probe_B(K, G, "cpu")


def test_window_take_over_windows_and_pads():
    rng = np.random.RandomState(0)
    nb, K, G = 5, 12, 4
    win = rng.rand(nb, K, 128).astype(np.float32)
    hi = rng.randint(-2, K + 2, (nb, G, 128)).astype(np.int32)
    flat = rng.randint(-5, K * 128 + 5, (nb, G, 128)).astype(np.int32)
    got = window_take(torch.as_tensor(win), torch.as_tensor(hi), "column").numpy()
    ok = (hi >= 0) & (hi < K)
    want = np.take_along_axis(win, np.where(ok, hi, 0), axis=1)
    np.testing.assert_array_equal(got, np.where(ok, want, 0.0))
    got = window_take(torch.as_tensor(win), torch.as_tensor(flat), "flat").numpy()
    ok = (flat >= 0) & (flat < K * 128)
    want = np.stack([win[b].reshape(-1)[np.where(ok[b], flat[b], 0)] for b in range(nb)])
    np.testing.assert_array_equal(got, np.where(ok, want, 0.0))
    with pytest.raises(ValueError):
        window_take(torch.as_tensor(win), torch.as_tensor(hi), "sublane")
    with pytest.raises(TypeError):
        window_take(torch.as_tensor(win).double(), torch.as_tensor(hi), "column")
    with pytest.raises(ValueError):  # no kernel off CPU and CUDA
        window_take(torch.as_tensor(win).to("meta"), torch.as_tensor(hi).to("meta"),
                    "column")
