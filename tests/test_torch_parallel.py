"""The port's sharded paths (arcanefem_tpu_torch/parallel/) against the JAX
package's sharded steps, on the CPU in float64.

The port runs one gloo process per rank (``dryrun.spawn``: P = 2 and 4,
spawned once per P for the module); JAX runs the same paths through
``shard_map`` on conftest's 8 virtual CPU devices at the same P.  Both
shard the same meshes the same way (``test_torch_parallel_partition.py``)
and both AMG paths shard the JAX hierarchy (``build_amg``'s arrays,
through the port's ``amg_from_numpy``).  Each path's gathered solution is
held to JAX's within 1e-10 of JAX's largest value, with the iterations
within 1; every rank also held it to the port's single-process solve with
the dryrun's tolerances (a failed check fails the spawn).  A single-rank
run in this process (a ``Comm`` of one rank needs no process group), the
shard assembly against the global dense matrix and one sharded V-cycle
against JAX's host V-cycle complete the counterparts of
tests/test_sharded.py and tests/test_sharded_amg.py."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcanefem_tpu.fem.problem import FemProblem as JaxProblem
from arcanefem_tpu.mesh.generate import box_tetra_mesh as jax_box, rect_tria_mesh as jax_rect
from arcanefem_tpu.mesh.structured import StructuredBox as JaxBox
from arcanefem_tpu.models.elasticity import lame
from arcanefem_tpu.models.elastodynamics import ElastodynamicsConfig, newmark_coefficients
from arcanefem_tpu.ops import elements as jax_elements
from arcanefem_tpu.parallel import block_sharded as jbs
from arcanefem_tpu.parallel import partition as jpart
from arcanefem_tpu.parallel import sharded as jsh
from arcanefem_tpu.parallel import sharded_amg as jamg
from arcanefem_tpu.parallel import sharded_window as jwin
from arcanefem_tpu.parallel import structured_mg as jmg
from arcanefem_tpu.parallel import structured_sharded as jslab
from arcanefem_tpu.solver.amg import build_amg
from arcanefem_tpu_torch.fem.problem import FemProblem
from arcanefem_tpu_torch.mesh.generate import rect_tria_mesh
from arcanefem_tpu_torch.ops import elements
from arcanefem_tpu_torch.parallel import dryrun
from arcanefem_tpu_torch.parallel.comm import Comm
from arcanefem_tpu_torch.parallel.partition import build_sharded
from arcanefem_tpu_torch.parallel.sharded import Shard, shard_assemble

PEN = dryrun.PEN
RTOL = 1e-11  # the dryrun's float64 solver tolerance
TOL = 1e-10  # port against JAX, of JAX's largest value
SCALAR_PATHS = ("rcb", "slab", "mg", "amg", "window")


def _as_numpy(M) -> dict:
    """The JAX hierarchy as the dict amg_from_numpy takes."""
    return {
        "mats": [(np.asarray(m.values).reshape(m.topo.n_nodes, m.topo.width),
                  np.asarray(m.cols)) for m in M.mats],
        **{k: [np.asarray(a) for a in getattr(M, k)]
           for k in ("inv_diags", "pcols", "pvals", "ptcols", "ptvals")},
        "coarse_inv": np.asarray(M.coarse_inv),
        "omegas": M.omegas, "rhos": M.rhos, "smoother": M.smoother,
        "cheb_deg": M.cheb_deg, "nu": M.nu, "cycle": M.cycle,
        "sawtooth": M.sawtooth, "l0_binv": None,
    }


def _dryrun_bcs(mesh):
    xmin, xmax = mesh.group_nodes("xmin"), mesh.group_nodes("xmax")
    return (np.concatenate([xmin, xmax]),
            np.concatenate([np.zeros(len(xmin)), np.ones(len(xmax))]))


@functools.cache
def _jax_amg():
    """The dryrun's hierarchy: build_amg(coarse_size=30) of the penalised
    global operator on box_tetra_mesh(6, 5, 4)."""
    mesh = jax_box(6, 5, 4)
    nodes, _ = _dryrun_bcs(mesh)
    Ag = JaxProblem(mesh, ndof=1, dtype=np.float64).assemble_matrix(
        lambda ct, xyz: jax_elements.stiffness(ct, xyz))
    d = Ag.diagonal().at[jnp.asarray(nodes)].set(PEN)
    flat = Ag.values.reshape(-1, 1, 1).at[jnp.asarray(Ag.topo.diag_slot)].set(
        d[:, None, None])
    amg = build_amg(Ag.with_values(flat.reshape(Ag.values.shape)), coarse_size=30)
    return amg, _as_numpy(amg)


def _structured_case(P, name):
    box = JaxBox(2 * P, 6, 5) if name == "slab" else JaxBox(4 * P, 6, 4)
    c3d = box.grid_coords(np.float64, jitter=0.1)
    bmask = box.boundary_mask(("xmin", "xmax"))
    gv = np.zeros(box.n_nodes)
    gv[box.boundary_mask(("xmax",))] = 1.0
    return box, c3d, bmask, gv


@functools.cache
def _jax_results(P: int) -> dict:
    """name -> (global solution(s), iterations) of the JAX sharded steps at
    P devices, as __graft_entry__._dryrun_body calls them (float64)."""
    out = {}
    dmesh = jsh.device_mesh(P)
    mesh = jax_box(6, 5, 4)
    sp = jpart.build_sharded(mesh, P)
    arrs = jsh.put_sharded(sp, dmesh, dtype=jnp.float64)
    nodes, vals = _dryrun_bcs(mesh)
    mask, val = jsh.stacked_node_mask(sp, nodes, vals)
    x, it, _ = jsh.make_poisson_step(sp, dmesh, rtol=RTOL, max_iter=2000)(
        arrs, 1.0, mask, val, PEN)
    out["rcb"] = (sp.scatter_global(np.asarray(x)), int(it))

    smesh = jax.sharding.Mesh(np.array(jax.devices()[:P]), ("xslabs",))
    shard = jax.sharding.NamedSharding(smesh, jax.sharding.PartitionSpec("xslabs"))
    put = lambda a: jax.device_put(jnp.asarray(a), shard)  # noqa: E731
    box, c3d, bmask, gv = _structured_case(P, "slab")
    plan = jslab.plan_slabs(box, P)
    ms, vs = jslab.slab_mask_values(plan, bmask, gv)
    x, it, _ = jslab.make_structured_step(plan, smesh, rtol=RTOL, max_iter=3000)(
        put(jslab.slab_coords(plan, c3d)), put(ms), put(vs), 1.0)
    out["slab"] = (jslab.gather_global(plan, np.asarray(x)), int(it))
    box, c3d, bmask, gv = _structured_case(P, "mg")
    mplan = jmg.plan_mg_slabs(box, P)
    _, vs = jslab.slab_mask_values(mplan.fine, bmask, gv)
    x, it, _ = jmg.make_structured_mg_step(mplan, smesh, rtol=RTOL, max_iter=200)(
        tuple(put(c) for c in jmg.mg_slab_coords(mplan, c3d)),
        tuple(put(m) for m in jmg.mg_slab_masks(mplan)), put(vs), 1.0)
    out["mg"] = (jslab.gather_global(mplan.fine, np.asarray(x)), int(it))

    amg, _ = _jax_amg()
    samg = jamg.build_sharded_amg(sp, amg)
    samg_arrs = jamg.put_sharded_amg(samg, dmesh, np.float64)
    x, it, _ = jamg.make_poisson_amg_step(sp, dmesh, samg, rtol=RTOL, max_iter=200)(
        arrs, samg_arrs, samg.inner, 1.0, mask, val, PEN)
    out["amg"] = (sp.scatter_global(np.asarray(x)), int(it))
    swp = jwin.build_sharded_window_plan(sp)
    x, it, _ = jwin.make_window_amg_step(sp, dmesh, samg, swp, rtol=RTOL, max_iter=200)(
        arrs, samg_arrs, jwin.put_sharded_window(swp, dmesh), samg.inner, 1.0, mask,
        val, PEN)
    out["window"] = (sp.scatter_global(np.asarray(x)), int(it))

    b = 3
    lam_l, mu2 = lame(dryrun.E_EL, dryrun.NU_EL)
    clamp = mesh.group_nodes("xmin")
    bmask, bval = jbs.stacked_dof_mask(sp, b, [(clamp, c, 0.0) for c in range(b)])
    x, it, _ = jbs.make_elasticity_step(sp, dmesh, lam_l, mu2, rtol=RTOL, max_iter=4000,
                                        ndof=b)(
        arrs, jnp.asarray([0.0, 0.0, -1.0]), jnp.asarray(bmask), jnp.asarray(bval), PEN)
    out["elasticity"] = (sp.scatter_global(np.asarray(x)), int(it))

    tmesh = jax_box(4, 3, 3)
    tsp = jpart.build_sharded(tmesh, P)
    tcfg = ElastodynamicsConfig(tmax=0.3, dt=0.1, rho=1.0, E=2.0, nu=0.3, penalty=PEN)
    mu_t = tcfg.E / (2 * (1 + tcfg.nu))
    lam_t = tcfg.E * tcfg.nu / ((1 + tcfg.nu) * (1 - 2 * tcfg.nu))
    cc, gamma_t, beta_t = newmark_coefficients(tcfg, lam_t, mu_t)
    tmask, tval = jbs.stacked_dof_mask(tsp, b, [(tmesh.group_nodes("xmin"), c, 0.0)
                                                 for c in range(b)])
    U, V, _A, it = jbs.make_elastodynamics_loop(
        tsp, dmesh, cc, gamma_t, beta_t, tcfg.dt, n_steps=3, rtol=RTOL, max_iter=4000,
        ndof=b)(jsh.put_sharded(tsp, dmesh, dtype=jnp.float64),
                jnp.asarray([0.0, 0.0, -1.0]), jnp.asarray(tmask), jnp.asarray(tval), PEN)
    out["elastodyn"] = ((tsp.scatter_global(np.asarray(U)),
                         tsp.scatter_global(np.asarray(V))), int(it))
    return out


@functools.cache
def _jax_host_vcycle() -> np.ndarray:
    amg, _ = _jax_amg()
    r = np.random.RandomState(3).rand(amg.mats[0].topo.n_nodes)
    return np.asarray(amg.apply(jnp.asarray(r)))


def _load(path) -> tuple[dict, dict]:
    z = np.load(path)
    return json.loads(str(z["records"])), {k: z[k] for k in z.files if k != "records"}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    """One spawn of P gloo ranks running every dryrun path (float64, the
    JAX hierarchy on the AMG paths); (P, records, rank 0's arrays)."""
    P = request.param
    d = tmp_path_factory.mktemp(f"ranks{P}")
    rc = dryrun.spawn(P, device="cpu", f64=True, inputs={"amg": _jax_amg()[1]},
                      out=str(d / "out.npz"), timeout_s=240, run_dir=str(d))
    assert rc == 0, "a rank failed or a path missed the single-process solve"
    return (P, *_load(d / "out.npz"))


def _close(got, want, tol=TOL) -> float:
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()
                / np.abs(np.asarray(want)).max())
    assert err <= tol, err
    return err


@pytest.mark.parametrize("name", SCALAR_PATHS + ("elasticity",))
def test_path_matches_jax_sharded(ranks, name):
    P, records, arrays = ranks
    want, it = _jax_results(P)[name]
    _close(arrays[f"{name}_x"], want)
    assert abs(records[name]["iterations"] - it) <= 1


def test_elastodynamics_trajectories_match_jax(ranks):
    P, records, arrays = ranks
    (wU, wV), it = _jax_results(P)["elastodyn"]
    _close(arrays["elastodyn_U"], wU)
    _close(arrays["elastodyn_V"], wV)
    assert records["elastodyn"]["steps"] == 3
    assert abs(records["elastodyn"]["iterations"] - it) <= 3  # ±1 per step


def test_paths_hold_to_single_process_solve(ranks):
    """Every path's record carries its difference from the single-process
    solve (checked in the ranks with the dryrun's tolerances), a free-row
    true residual and the collectives of its iterations."""
    P, records, _ = ranks
    assert set(records) == set(dryrun.PATHS)
    for name, rec in records.items():
        assert rec["max_diff"] <= 1e-6, (name, rec)
        if name != "vcycle":
            assert rec["true_residual"] <= 1e-8, (name, rec)
        coll = rec["collectives"]
        assert coll["all_reduce"] > 0, (name, coll)
        if name in ("slab", "mg"):
            assert coll["p2p"] > 0 and coll["all_gather"] == 0, (name, coll)
        else:
            assert coll["all_gather"] > 0 and coll["p2p"] == 0, (name, coll)


def test_sharded_vcycle_matches_host_vcycle(ranks):
    """One distributed V-cycle (fine level sharded over P ranks) == the JAX
    host AMGPrecond.apply of the same hierarchy."""
    _, _, arrays = ranks
    _close(arrays["vcycle_x"], _jax_host_vcycle())


def test_single_rank_matches_jax():
    """Every path on one rank in this process (no process group: a Comm of
    one rank makes no collective) against JAX's one-device steps."""
    out = dryrun.run_rank(Comm(0, 1, torch.device("cpu")), f64=True,
                          inputs={"amg": _jax_amg()[1]})
    arrays = out.pop("_arrays")
    want = _jax_results(1)
    for name in SCALAR_PATHS + ("elasticity",):
        _close(arrays[f"{name}_x"], want[name][0])
        assert abs(out[name]["iterations"] - want[name][1]) <= 1, name
    _close(arrays["elastodyn_U"], want["elastodyn"][0][0])
    _close(arrays["vcycle_x"], _jax_host_vcycle())
    assert all(sum(r["collectives"].values()) == 0 for r in out.values())


def test_sharded_matrix_matches_dense():
    """The shards' assembled rows (slot_reduce into each shard's SELL
    layout), mapped back to global ids, == the single-topology dense
    matrix of the port and of JAX."""
    mesh = rect_tria_mesh(6, 5)
    dense_ref = FemProblem(mesh, ndof=1, dtype=torch.float64, device="cpu") \
        .assemble_matrix(elements.stiffness).todense().numpy()
    jax_dense = np.asarray(JaxProblem(jax_rect(6, 5), ndof=1, dtype=np.float64)
                           .assemble_matrix(jax_elements.stiffness).todense())
    np.testing.assert_allclose(dense_ref, jax_dense, rtol=1e-12, atol=1e-14)
    sp = build_sharded(mesh, 4)
    dense = np.zeros_like(dense_ref)
    for p in range(4):
        sh = Shard(sp, p, "cpu", torch.float64)
        vals = sh.layout.to_ell(shard_assemble(sh)).numpy()
        k = sp.n_own[p]
        own = sp.owned_global[p, :k]
        l2g = np.full(sp.n_own_max + sp.h_max, -1, np.int64)
        l2g[:k] = own
        touched = np.unique(np.concatenate([
            mesh.cells[n][sp.cell_offsets[n][p][sp.cell_offsets[n][p] >= 0]].ravel()
            for n in mesh.cells]))
        halo = touched[sp.part[touched] != p]
        l2g[sp.n_own_max:sp.n_own_max + len(halo)] = halo
        for i in range(sp.n_own_max):
            for w, c in enumerate(sp.ell_cols[p, i]):
                if sh.real[i, w]:
                    assert i < k and l2g[c] >= 0
                    dense[own[i], l2g[c]] += vals[i, w]
    np.testing.assert_allclose(dense, dense_ref, rtol=1e-10, atol=1e-12)
