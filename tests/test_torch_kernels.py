"""The CUDA kernels (arcanefem_tpu_torch/csrc/ell_gather.cu) against their
plain twins.  This file imports no jax, so on the card's machine, which has
none, it runs without the tests' conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Without a CUDA device the card cases skip."""

import numpy as np
import pytest
import torch

from arcanefem_tpu_torch.bench_unstructured import (
    solve_sphere_cut,
    sphere_cut_system,
)
from arcanefem_tpu_torch.sparse.bell import BellMatrix
from arcanefem_tpu_torch.sparse.ell_gather import (
    ell_gather_sum,
    ell_gather_sum_plain,
    ell_spmv,
    ell_spmv_plain,
    launch_counts,
    reset_launch_counts,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def test_wrappers_check_operands():
    cols = torch.zeros((4, 2), dtype=torch.int32)
    x = torch.zeros(4)
    with pytest.raises(TypeError):
        ell_spmv(torch.zeros(4, 2), cols.long(), x)
    with pytest.raises(ValueError):
        ell_spmv(torch.zeros(4, 3), cols, x)
    with pytest.raises(TypeError):
        ell_spmv(torch.zeros(4, 2, dtype=torch.float64), cols, x)
    with pytest.raises(ValueError):
        ell_gather_sum(cols, torch.zeros(4, 1))
    with pytest.raises(ValueError):
        ell_gather_sum(cols.to("meta"), x.to("meta"))
    with pytest.raises(ValueError):
        BellMatrix.from_numpy(np.zeros((4, 2)), np.full((4, 2), 4),
                              device="cpu", dtype=torch.float64)


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers run the plain twin and count nothing."""
    reset_launch_counts()
    cols = torch.tensor([[0, 1], [1, -1]], dtype=torch.int32)
    x = torch.tensor([2.0, 3.0])
    vals = torch.tensor([[1.0, 0.5], [2.0, 0.0]])
    assert ell_spmv(vals, cols.clamp(min=0), x).tolist() == [3.5, 6.0]
    assert ell_gather_sum(cols, x).tolist() == [5.0, 3.0]
    assert launch_counts() == {"ell_spmv": 0, "ell_gather_sum": 0}


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
def test_kernels_match_plain_on_cuda(cuda, dtype, rtol):
    """Each kernel == its plain twin on the card, with padding and wide
    rows; the error is measured against sum |v·x| of each row."""
    gen = torch.Generator().manual_seed(0)
    reset_launch_counts()
    for W in (1, 8, 25, 136):
        n = 50_000
        cols = torch.randint(0, n, (n, W), generator=gen, dtype=torch.int32)
        vals = torch.rand((n, W), generator=gen, dtype=dtype) * 2 - 1
        pad = torch.rand((n, W), generator=gen) < 0.2
        vals[pad] = 0
        ucols = torch.where(pad, -1, cols)
        x = torch.rand(n, generator=gen, dtype=dtype) * 2 - 1
        cols, vals, ucols, x = (t.to(cuda) for t in (cols, vals, ucols, x))
        y, u = ell_spmv(vals, cols, x), ell_gather_sum(ucols, x)
        torch.cuda.synchronize()
        assert y.dtype == u.dtype == dtype
        scale = ell_spmv_plain(vals.abs(), cols, x.abs())
        uscale = ell_gather_sum_plain(ucols, x.abs())
        assert bool(((y - ell_spmv_plain(vals, cols, x)).abs()
                     <= rtol * scale).all())
        assert bool(((u - ell_gather_sum_plain(ucols, x)).abs()
                     <= rtol * uscale).all())
    assert launch_counts() == {"ell_spmv": 4, "ell_gather_sum": 4}


def test_slice_on_cuda_matches_plain_and_cpu(cuda):
    """The h=14 slice in f32 through the kernels == the same slice on the
    plain twins, and == the f64 CPU solve to 1e-4 of max|x|."""
    mesh, topo = sphere_cut_system(14.0, 0, cache=False)
    reset_launch_counts()
    k = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32,
                         penalty=1e12)
    assert all(c > 0 for c in launch_counts().values())
    p = solve_sphere_cut(mesh, topo, device=cuda, dtype=torch.float32,
                         penalty=1e12, plain=True)
    c = solve_sphere_cut(mesh, topo, device="cpu", dtype=torch.float64,
                         penalty=1e30)
    xk = k["x"].cpu()
    for other in (p, c):
        assert abs(other["iterations"] - k["iterations"]) <= 1
        xo = other["x"].cpu()
        assert float((xk - xo).abs().max()) <= 1e-4 * float(xo.abs().max())
    assert k["rel"] <= 1e-8 and k["true_residual"] <= 1e-4
