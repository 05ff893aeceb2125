"""The port's unstructured Poisson route on the sphere_cut mesh.

Set-up, as ``bench_unstructured.solve_sphere_cut`` composes it with its
caches off: the mesh and topology (the port's npz files under
``AFEM_CACHE_DIR``, made by the first run), the fine SELL layout,
``TetraAssembler`` (split coordinates, window reduce), the f = 1 load
vector and the Dirichlet rows (``dirichlet_data``) and, for the solve
traffic, the smoothed-aggregation AMG hierarchy of the assembled
operator, set up on the host.

A load case (``case``) re-assembles the lhs from the coordinates, writes
the penalty rows, forms b = f·(load of f = 1) + g·penalty on the sphere
rows and x0 = g there, and runs the port's ``pcg`` with compensated dots.
An assembly (``assemble``) is ``TetraAssembler.__call__`` plus the
penalty rows, on one of a bank of coordinate sets that ``seed`` makes on
the device: the nodes moved by a uniform displacement of at most
``displacement`` times the shortest edge.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from arcanefem_tpu_torch.bench_unstructured import (
    dirichlet_data,
    launch_counts,
    sphere_cut_system,
)
from arcanefem_tpu_torch.ops.lane_assembly import TetraAssembler
from arcanefem_tpu_torch.solver.amg import amg_cached
from arcanefem_tpu_torch.solver.amg_setup import amg_setup
from arcanefem_tpu_torch.solver.iterative import pcg
from arcanefem_tpu_torch.sparse.bell import BellMatrix, fine_layout
from benchmark.core import nospan, sync, worst
from benchmark.reference import compare, p1_tetra


class System:
    def __init__(self, config: dict, mix: dict, device, *, plain: bool = False,
                 mesh_cache: bool = True, spans: dict):
        mesh_cfg, route = config["mesh"], config["route"]
        self.device = torch.device(device)
        self.plain = plain
        self.penalty = float(config["boundary"]["penalty"])
        self.rtol = float(route["rtol"])
        self.max_iter = int(route["max_iter"])
        self.mix = mix
        t = time.perf_counter()
        mesh, topo = sphere_cut_system(mesh_cfg["h"], mesh_cfg["refine"], cache=mesh_cache)
        spans["mesh_s"] = time.perf_counter() - t
        self.mesh, self.topo = mesh, topo
        self.n_dofs = int(topo.n_nodes)
        self.n_cells = int(mesh.cells["tetra4"].shape[0])
        self.nnz = int(topo.nnz)
        dev = self.device
        self.layout = fine_layout(topo, dev)
        self.asm = TetraAssembler(topo, mesh.cells["tetra4"], device=dev, plain=plain,
                                  layout=self.layout, reduce=route["asm_reduce"])
        self.coords = torch.as_tensor(mesh.coords, device=dev).to(torch.float32)
        mask, g1, rhs = dirichlet_data(mesh, self.penalty)
        self.mask = mask
        self.diag = torch.as_tensor(
            self.layout.ell_to_sell[np.asarray(topo.diag_slot, np.int64)], device=dev)
        self.diag_dir = self.diag[torch.as_tensor(mask, device=dev)]
        self.b1 = torch.as_tensor(np.where(mask, 0.0, rhs), device=dev).to(torch.float32)
        self.sph = torch.as_tensor(g1, device=dev).to(torch.float32)  # 1 on sphere rows
        self.pg1 = self.sph * self.penalty
        self.M = None
        self.bank = None
        if mix["kind"] == "closed_loop":
            amg = route["amg"]
            flat = BellMatrix(self.lhs(self.coords), self.layout, self.diag,
                              plain=plain).ell_values().cpu().numpy()
            t = time.perf_counter()
            M, _ = amg_cached(None, None, lambda: amg_setup(
                flat, topo, theta=amg["theta"], smoother=amg["smoother"],
                cheb_deg=amg["cheb_deg"], dtype=np.float32), dev, torch.float32,
                plain=plain)
            spans["amg_setup_s"] = time.perf_counter() - t
            self.M = M.replace(smoother=amg["smoother"], cheb_deg=amg["cheb_deg"],
                               cycle=amg["cycle"])

    # -- what the traffic drives -------------------------------------------

    def seed(self, seed: int) -> None:
        """The seeded inputs: the coordinate bank of the assembly traffic."""
        if self.mix["kind"] != "stream":
            return
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        d = float(self.mix["displacement"]) * self.shortest_edge()
        base = self.coords.to(torch.float64)
        noise = torch.rand((int(self.mix["bank"]),) + tuple(base.shape), generator=gen,
                           device=self.device, dtype=torch.float64)
        self.bank = ((noise * 2.0 - 1.0) * d + base).to(torch.float32)

    def shortest_edge(self) -> float:
        tets = torch.as_tensor(self.mesh.cells["tetra4"], device=self.device).long()
        c = self.coords.to(torch.float64)
        best = float("inf")
        for a in range(4):
            for b in range(a + 1, 4):
                e = torch.linalg.vector_norm(c[tets[:, a]] - c[tets[:, b]], dim=1)
                best = min(best, float(e.min()))
        return best

    def lhs(self, coords: torch.Tensor) -> torch.Tensor:
        vals = self.asm(coords)
        vals[self.diag_dir] = self.penalty
        return vals

    def assemble(self, k: int) -> torch.Tensor:
        return self.lhs(self.bank[k])

    def case(self, p: dict, ev=None, span=None) -> dict:
        span = span or nospan
        if ev:
            ev[0].record()
        with span("assemble"):
            vals = self.lhs(self.coords)
            A = BellMatrix(vals, self.layout, self.diag, plain=self.plain)
        with span("load"):
            b = p["f"] * self.b1 + p["g"] * self.pg1
            x0 = p["g"] * self.sph
        if ev:
            ev[1].record()
        with span("pcg"):
            x, k, rel = pcg(A, b, self.M, x0, self.rtol, 0.0, self.max_iter,
                            use_precise_dot=True)
        if ev:
            ev[2].record()
        return {"p": p, "iterations": k, "rel": rel, "x": x, "b": b, "vals": vals}

    def keep(self, out: dict, last: bool = False) -> dict:
        """What the check reads of an output; the last case keeps its lhs."""
        if "k" in out:  # an assembly
            return {"k": out["k"], "vals": out["vals"] if last else out["vals"].clone()}
        kept = {"p": out["p"], "x": out["x"] if last else out["x"].clone(),
                "b": out["b"] if last else out["b"].clone()}
        if last:
            kept["vals"] = out["vals"]
        return kept

    def counts(self) -> dict:
        return launch_counts()

    def sync(self) -> None:
        sync(self.device)

    def release(self) -> None:
        """Drop the program's state that the check does not read."""
        self.asm = self.M = None

    # -- the check ---------------------------------------------------------

    def _reference(self, coords: torch.Tensor):
        tets = torch.as_tensor(self.mesh.cells["tetra4"], device=self.device)
        return p1_tetra.stiffness(coords, tets)

    def _program_entries(self, vals: torch.Tensor):
        """(sorted keys, values) of the program's stored entries."""
        n, topo = self.n_dofs, self.topo
        ell = self.layout.to_ell(vals)
        valid = torch.as_tensor(np.asarray(topo.ell_valid), device=self.device)
        cols = torch.as_tensor(np.asarray(topo.ell_cols), device=self.device).long()
        rows = torch.arange(n, device=self.device)[:, None].expand_as(cols)
        keys = (rows * n + cols)[valid]
        keys, order = torch.sort(keys)
        return keys, ell[valid][order]

    def _lhs_err(self, ref, vals: torch.Tensor | None, control: bool) -> float:
        keys, K = ref
        n = self.n_dofs
        rows, cols = keys // n, keys % n
        dirichlet = torch.as_tensor(self.mask, device=self.device)
        pen = dirichlet[rows] & (rows == cols)
        want = torch.where(pen, torch.full_like(K, self.penalty), K)
        scale = compare.entry_scale(p1_tetra.row_max(keys, K, n)[rows], pen, self.penalty)
        if control:
            return compare.matrix_err(compare.lower(want), want, scale)
        kp, vp = self._program_entries(vals)
        if kp.shape != keys.shape or not torch.equal(kp, keys):
            return float("inf")  # not the mesh's sparsity pattern
        return compare.matrix_err(vp, want, scale)

    def check(self, samples: list, last: dict, control: bool = False) -> dict:
        """The numbers of the cell's limits, worst over the kept outputs;
        ``control`` puts the reference in the program's place, rounded
        to the precision below."""
        numbers: dict = {}
        if "k" in last:  # the assembly traffic: the lhs alone
            for kept in samples + [last]:
                ref = self._reference(self.bank[kept["k"]])
                worst(numbers, {"lhs_err": self._lhs_err(ref, kept["vals"], control)})
            return numbers
        ref = self._reference(self.coords)
        worst(numbers, {"lhs_err": self._lhs_err(ref, last["vals"], control)})
        keys, K = ref
        dev = self.device
        tets = torch.as_tensor(self.mesh.cells["tetra4"], device=dev)
        load1 = p1_tetra.lumped_load(torch.as_tensor(self.mesh.coords, device=dev), tets, 1.0)
        dirichlet = torch.as_tensor(self.mask, device=dev)
        sph = self.sph.to(torch.float64)
        for kept in samples + [last]:
            f, g = kept["p"]["f"], kept["p"]["g"]
            b_ref = torch.where(dirichlet, self.penalty * g * sph, f * load1)
            b = compare.lower(b_ref) if control else kept["b"]
            x = compare.lower(kept["x"]) if control else kept["x"]
            ax = p1_tetra.spmv(keys, K, self.n_dofs, x)
            abs_ax = p1_tetra.spmv(keys, K.abs(), self.n_dofs, x.abs())
            worst(numbers, {
                "load_err": compare.load_err(b, b_ref, dirichlet, self.penalty),
                "x_backward_err": compare.x_backward_err(ax, abs_ax, b_ref, ~dirichlet),
                "x_bc_err": compare.x_bc_err(x, g * sph, dirichlet)})
        return numbers

