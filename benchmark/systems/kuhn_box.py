"""The port's structured Poisson route on the jittered Kuhn box.

Set-up: the box's Dirichlet planes (x = 0 and x = 1) in the port's
padded plane layout, for the fine level and every multigrid level.
``seed`` makes the node coordinates on the device: the unit grid, its
interior nodes moved by up to ``jitter`` of the spacing along each axis
(uniform), in float32.

A load case (``case``) draws g, the value on x = 1, sets the port's
penalty·g and warm-start planes from it, and runs one
``bench_structured.solve_mg`` pass: the fused assembly (K4) with the load
and the penalty rows, the geometric multigrid hierarchy, and MG-PCG with
compensated dots, its residual recomputed in float64 every
``replace_every`` iterations (0: never).
"""

from __future__ import annotations

import numpy as np
import torch

from arcanefem_tpu_torch import bench_structured
from arcanefem_tpu_torch.bench_structured import BoxSystem, Options, solve_mg
from arcanefem_tpu_torch.mesh import stencil_assembly
from arcanefem_tpu_torch.mesh.structured import StructuredBox
from arcanefem_tpu_torch.solver.multigrid import level_masks_p
from arcanefem_tpu_torch.sparse import dia_stencil
from arcanefem_tpu_torch.sparse.dia_stencil import KUHN_OFFS3, pad_host_vec, unpad_vec
from benchmark.core import nospan, sync, worst
from benchmark.reference import compare, kuhn_box

CENTER = kuhn_box.offset_index((0, 0, 0))


class System:
    def __init__(self, config: dict, mix: dict, device, *, plain: bool = False,
                 mesh_cache: bool = True, spans: dict):
        route = config["route"]
        n = int(config["mesh"]["n"])
        self.device = torch.device(device)
        self.jitter = float(config["mesh"]["jitter"])
        self.penalty = float(config["boundary"]["penalty"])
        if self.penalty != bench_structured.PENALTY:
            raise ValueError(f"solve_mg penalises with {bench_structured.PENALTY:g}, "
                             f"the configuration states {self.penalty:g}")
        self.opts = Options(nu=route["nu"], smoother=route["smoother"],
                            mg_bf16=route["mg_bf16"], fused=route["fused"],
                            chunk=route["chunk"], rtol=route["rtol"])
        self.rtol = float(route["rtol"])
        self.max_iter = int(route["max_iter"])  # solve_mg's own cap, which it does not take
        self.replace_every = int(route["replace_every"])
        for key, have in (("omega", bench_structured.OMEGA),
                          ("coarse_iters", bench_structured.COARSE_ITERS),
                          ("min_size", bench_structured.MIN_SIZE)):
            if route[key] != have:
                raise ValueError(f"solve_mg runs {key} = {have}, the configuration "
                                 f"states {route[key]}")
        self.box = box = StructuredBox(n, n, n)
        self.n_dofs = box.n_nodes
        self.mask = box.boundary_mask(("xmin", "xmax"))
        self.xmax = box.boundary_mask(("xmax",)).astype(np.float64)

        def plane(v):
            return torch.as_tensor(pad_host_vec(box, v, np.float64),
                                   device=self.device).to(torch.float32)

        self.mask_p = plane(self.mask)
        self.pg1_p = plane(self.penalty * self.xmax)
        self.x01_p = plane(self.xmax)
        self.masks_p = level_masks_p(box, self.mask, min_size=bench_structured.MIN_SIZE,
                                     device=self.device, dtype=torch.float32)
        self.s = None

    def seed(self, seed: int) -> None:
        """The seeded node coordinates, (n+1, n+1, n+1, 3) float32."""
        box, dev = self.box, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        axes = [torch.linspace(0.0, 1.0, k, dtype=torch.float64, device=dev)
                for k in box.shape]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        h = torch.tensor([1.0 / box.nx, 1.0 / box.ny, 1.0 / box.nz],
                         dtype=torch.float64, device=dev)
        d = (torch.rand(grid.shape, generator=gen, dtype=torch.float64, device=dev)
             - 0.5) * (2.0 * self.jitter) * h
        d[0] = d[-1] = 0.0
        d[:, 0] = d[:, -1] = 0.0
        d[:, :, 0] = d[:, :, -1] = 0.0
        c3 = (grid + d).to(torch.float32)
        self.s = BoxSystem(box, c3, self.mask, self.xmax, self.mask_p,
                           self.pg1_p.clone(), self.x01_p.clone(), self.masks_p)

    def case(self, p: dict, ev=None, span=None) -> dict:
        span = span or nospan
        s = self.s
        with span("load"):
            s.pg_p = p["g"] * self.pg1_p
            s.x0_p = p["g"] * self.x01_p
        if ev:
            ev[0].record()
        with span("solve_mg"):
            res = solve_mg(s, replace_every=self.replace_every,
                           events=ev[1:3] if ev else None, opts=self.opts)
        return {"p": p, "iterations": res["iterations"], "rel": res["rel"],
                "x": res["x"], "b": res["b"], "A": res["A"]}

    def keep(self, out: dict, last: bool = False) -> dict:
        if last:
            return {"p": out["p"], "x": out["x"], "b": out["b"], "A": out["A"]}
        return {"p": out["p"], "x": out["x"].clone(), "b": out["b"].clone()}

    def counts(self) -> dict:
        return {**stencil_assembly.launch_counts(), **dia_stencil.launch_counts()}

    def sync(self) -> None:
        sync(self.device)

    def release(self) -> None:
        pass  # a pass frees its hierarchy; the check reads the kept outputs

    # -- the check ---------------------------------------------------------

    def check(self, samples: list, last: dict, control: bool = False) -> dict:
        box = self.box
        shape = box.shape
        S, load1 = kuhn_box.assemble(self.s.coords3d, f=1.0)
        dirichlet = torch.as_tensor(self.mask, device=self.device).reshape(shape)
        xmax = torch.as_tensor(self.xmax, device=self.device).reshape(shape)
        numbers: dict = {}
        worst(numbers, {"bands_err": self._bands_err(S, dirichlet, last["A"], control)})
        for kept in samples + [last]:
            g = kept["p"]["g"]
            b_ref = torch.where(dirichlet, self.penalty * g * xmax, load1)
            if control:
                b, x = compare.lower(b_ref), compare.lower(kept["x"]).reshape(shape)
            else:
                b, x = unpad_vec(kept["b"], shape).reshape(shape), kept["x"].reshape(shape)
            worst(numbers, {
                "rhs_err": compare.load_err(b, b_ref, dirichlet, self.penalty),
                "x_backward_err": compare.x_backward_err(
                    kuhn_box.apply(S, x), kuhn_box.apply(S.abs(), x.abs()), b_ref, ~dirichlet),
                "x_bc_err": compare.x_bc_err(x, g * xmax, dirichlet)})
        return numbers

    def _bands_err(self, S, dirichlet, A, control: bool) -> float:
        """Worst entry of the program's 15 bands (and of the 12 stencil
        offsets it does not store, which must be 0) against the
        reference's 27-point stencil."""
        ny, nz = self.box.ny, self.box.nz
        stored = {kuhn_box.offset_index(o): t for t, o in enumerate(KUHN_OFFS3)}
        rowmax = kuhn_box.row_max(S)
        errs = {}
        for o in range(27):
            want = S[o]
            pen = dirichlet if o == CENTER else torch.zeros_like(dirichlet)
            if o == CENTER:
                want = torch.where(dirichlet, torch.full_like(want, self.penalty), want)
            scale = compare.entry_scale(rowmax, pen, self.penalty)
            if control:
                got = compare.lower(want)
            elif o in stored:
                got = A.bands_p[:, stored[o], 1 : ny + 2, 1 : nz + 2]
            else:
                got = torch.zeros_like(want)
            worst(errs, {"bands_err": compare.matrix_err(got, want, scale)})
        return errs["bands_err"]
