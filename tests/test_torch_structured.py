"""The structured Kuhn box and its assembly against the JAX package, in
float64 on the CPU: box geometry and masks (exact), the plain slice-add
assembly, source and penalty Dirichlet (1e-12 relative), the fused
assembly in the padded plane layout (1e-12 relative, pads exactly 0), and
the stencil-assembly kernel's hex tables: its two phases run on the CPU
through them, and the kernel source holds them verbatim."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.mesh.structured import apply_penalty_dirichlet as jax_penalty
from arcanefem_tpu_torch.mesh import stencil_assembly as sa
from arcanefem_tpu_torch.mesh.structured import _TETS, StructuredBox, apply_penalty_dirichlet
from arcanefem_tpu_torch.sparse.dia_stencil import D0, _pads, pad_host_vec

DIMS = [(4, 3, 5), (6, 5, 4)]
PENALTY = 1e12


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dims", DIMS + [(16, 12, 20)])
def test_box_geometry_equal(dims):
    b, j = StructuredBox(*dims), JaxBox(*dims)
    assert b.offsets == j.offsets and (b.sx, b.sy) == (j.sx, j.sy)
    assert (b.n_nodes, b.n_cells) == (j.n_nodes, j.n_cells)
    for jitter in (0.0, 0.1):
        np.testing.assert_array_equal(b.grid_coords(np.float64, jitter=jitter, seed=0),
                                      j.grid_coords(np.float64, jitter=jitter, seed=0))
    for planes in (("xmin", "xmax"), ("ymin", "zmax"), ("xmax",)):
        np.testing.assert_array_equal(b.boundary_mask(planes), j.boundary_mask(planes))


@pytest.mark.parametrize("dims", DIMS)
def test_plain_assembly_matches_jax(dims):
    """assemble_stiffness, source_rhs and apply_penalty_dirichlet against
    the JAX XLA assembly and its siblings, f64, 1e-12 relative."""
    b, j = StructuredBox(*dims), JaxBox(*dims)
    c = b.grid_coords(np.float64, jitter=0.1)
    ct, cj = torch.as_tensor(c), jnp.asarray(c)
    A, Aj = b.assemble_stiffness(ct), j.assemble_stiffness(cj, backend="xla")
    assert A.offsets == Aj.offsets
    assert _rel(A.bands.numpy(), Aj.bands) <= 1e-12
    rhs, rhsj = b.source_rhs(ct, 2.5), j.source_rhs(cj, 2.5)
    assert _rel(rhs.numpy(), rhsj) <= 1e-12
    mask = b.boundary_mask(("xmin", "xmax"))
    g = np.where(b.boundary_mask(("xmax",)), 1.0, 0.0)
    Ap, rp = apply_penalty_dirichlet(A, rhs, torch.as_tensor(mask),
                                     torch.as_tensor(g), PENALTY)
    Apj, rpj = jax_penalty(Aj, rhsj, jnp.asarray(mask), jnp.asarray(g), PENALTY)
    assert _rel(Ap.bands.numpy(), Apj.bands) <= 1e-12
    assert _rel(rp.numpy(), rpj) <= 1e-12
    free = ~mask
    assert _rel(rp.numpy()[free], np.asarray(rpj)[free]) <= 1e-12


@pytest.mark.parametrize("dims", DIMS)
def test_fused_assembly_matches_jax(dims):
    """The fused assembly (CPU: its plain twin), unpadded, == JAX XLA
    assembly + source_rhs + penalty Dirichlet; pads exactly 0."""
    b, j = StructuredBox(*dims), JaxBox(*dims)
    c = b.grid_coords(np.float64, jitter=0.1)
    mask = b.boundary_mask(("xmin", "xmax"))
    g = np.where(b.boundary_mask(("xmax",)), 1.0, 0.0)
    mask_p = torch.as_tensor(pad_host_vec(b, mask, np.float64))
    pg_p = torch.as_tensor(pad_host_vec(b, PENALTY * g * mask, np.float64))
    Ap, rhs_p = sa.assemble_system(b, torch.as_tensor(c), mask_p, pg_p, PENALTY, f=3.0)

    cj = jnp.asarray(c)
    Aj, rj = jax_penalty(j.assemble_stiffness(cj, backend="xla"), j.source_rhs(cj, 3.0),
                         jnp.asarray(mask), jnp.asarray(g), PENALTY)
    bands = np.stack([Ap.unpad_vec(Ap.bands_p[:, d]).numpy() for d in range(15)])
    assert _rel(bands, Aj.bands) <= 1e-12
    free = ~mask
    assert _rel(bands[:, free], np.asarray(Aj.bands)[:, free]) <= 1e-12
    np.testing.assert_array_equal(bands[D0][mask], PENALTY)
    assert _rel(Ap.unpad_vec(rhs_p).numpy(), rj) <= 1e-12
    assert _rel(Ap.unpad_vec(rhs_p).numpy()[free], np.asarray(rj)[free]) <= 1e-12

    nyp, nzp = _pads(b)
    assert tuple(Ap.bands_p.shape) == (b.nx + 1, 15, nyp, nzp)
    real = np.zeros((b.nx + 1, nyp, nzp), bool)
    real[:, 1 : b.ny + 2, 1 : b.nz + 2] = True
    assert (rhs_p.numpy()[~real] == 0).all()
    assert (Ap.bands_p.numpy().transpose(1, 0, 2, 3)[:, ~real] == 0).all()

    # without the BC planes: the stiffness and the raw sum of vol/4
    A0, vs = sa.assemble_system(b, torch.as_tensor(c))
    assert _rel(A0.unpad_vec(vs).numpy(), j.source_rhs(cj, 1.0)) <= 1e-12


@pytest.mark.parametrize("dims", DIMS)
def test_stiffness_kernel_entry_on_cpu(dims):
    """assemble_stiffness_kernel runs its plain twin on a CPU tensor and
    launches nothing; a malformed input raises."""
    b = StructuredBox(*dims)
    c = torch.as_tensor(b.grid_coords(np.float64, jitter=0.1))
    sa.reset_launch_counts()
    A = sa.assemble_stiffness_kernel(b, c)
    assert torch.equal(A.bands, b.assemble_stiffness(c).bands)
    assert sa.launch_counts() == {"stencil_assembly": 0}
    with pytest.raises(ValueError):
        sa.assemble_stiffness_kernel(b, c[:-1])
    with pytest.raises(TypeError):
        sa.assemble_stiffness_kernel(b, c.to(torch.int64))
    with pytest.raises(ValueError):
        sa.assemble_system(b, c, torch.zeros(3))


@pytest.mark.parametrize("layout", ["plane", "dia"])
@pytest.mark.parametrize("dims", DIMS)
def test_hex_table_assembly_matches_jax(dims, layout):
    """K4's two phases on the CPU (assemble_by_hex_table: each hex's 6 tets
    once into its table, then each node's sum through CORNER_SLOT and
    CORNER_BAND) == the JAX XLA assembly, source_rhs and penalty Dirichlet
    in f64 to 1e-12, in the kernel's two output layouts, pads exactly 0."""
    b, j = StructuredBox(*dims), JaxBox(*dims)
    c = b.grid_coords(np.float64, jitter=0.1)
    ct, cj = torch.as_tensor(c), jnp.asarray(c)
    off = 1 if layout == "plane" else 0
    nyo, nzo = _pads(b) if off else b.shape[1:]
    real = np.zeros((b.nx + 1, nyo, nzo), bool)
    real[:, off : off + b.ny + 1, off : off + b.nz + 1] = True

    def unpad(bands, rhs):
        bands = bands.numpy()
        if off:
            bands = bands.transpose(1, 0, 2, 3)
        assert (bands[:, ~real] == 0).all() and (rhs.numpy()[~real] == 0).all()
        return bands[:, real], rhs.numpy()[real]

    mask = b.boundary_mask(("xmin", "xmax"))
    g = np.where(b.boundary_mask(("xmax",)), 1.0, 0.0)
    Aj = j.assemble_stiffness(cj, backend="xla")
    Apj, rpj = jax_penalty(Aj, j.source_rhs(cj, 3.0), jnp.asarray(mask),
                           jnp.asarray(g), PENALTY)
    bands, vs = unpad(*sa.assemble_by_hex_table(b, ct, layout=layout))
    assert _rel(bands, Aj.bands) <= 1e-12
    assert _rel(vs, j.source_rhs(cj, 1.0)) <= 1e-12

    def plane(v):  # a flat node vector in the output layout's plane
        p = np.zeros((b.nx + 1, nyo, nzo))
        p[real] = v
        return torch.as_tensor(p)

    bands, rhs = unpad(*sa.assemble_by_hex_table(
        b, ct, plane(mask), plane(PENALTY * g * mask), PENALTY, 3.0, layout=layout))
    free = ~mask
    assert _rel(bands, Apj.bands) <= 1e-12
    assert _rel(bands[:, free], np.asarray(Apj.bands)[:, free]) <= 1e-12
    np.testing.assert_array_equal(bands[D0][mask], PENALTY)
    assert _rel(rhs, rpj) <= 1e-12
    assert _rel(rhs[free], np.asarray(rpj)[free]) <= 1e-12


def test_hex_tables_match_kernel_source():
    """The kernel source holds kernel_tables() verbatim, and the tables
    are the Kuhn split's: 19 edges (12 cube edges, 6 face diagonals, the
    body diagonal), each tet's 6 local edges on 6 distinct hex edges,
    corners 0 and 6 on 7 edges and the others on 4, each edge read from
    both ends with mirrored bands, and no off-diagonal read lands on the
    diagonal band."""
    src = (Path(sa.__file__).parents[1] / "csrc" / "stencil_assembly.cu").read_text()
    assert sa.kernel_tables() in src
    assert len(sa.HEX_EDGES) == 19 and sa.HEX_SLOTS == 27
    for t, corners in zip(sa.TET_EDGE, _TETS):
        assert len(set(t)) == 6
        for e, (q, r) in zip(t, sa.TET_PAIRS):
            assert sa.HEX_EDGES[e] == tuple(sorted((corners[q], corners[r])))
    reads = {}
    for h in range(8):
        real = [(s, d) for s, d in zip(sa.CORNER_SLOT[h], sa.CORNER_BAND[h]) if s >= 0]
        assert len(real) == (7 if h in (0, 6) else 4)
        for s, d in real:
            assert h in sa.HEX_EDGES[s] and d != D0
            reads.setdefault(s, []).append(d)
    assert sorted(reads) == list(range(sa.VOL_SLOT0))
    for d1, d2 in reads.values():
        assert d1 + d2 == 2 * D0  # offsets o and -o: bands mirror about D0
