"""How far float32 carries the heat model on an n x n tria3 rect.

    python -m arcanefem_tpu_torch.tools.heat_floor [--n 100 200 400] [--device cpu]

The configuration of chip_smoke's ``[transient]`` T2 (a) (:func:`config`):
Dirichlet T = 0 on ``left``, convection (h 2, Text 0.5) on ``right``, a
constant qdot of 1, dt 0.1, 10 implicit Euler steps, CG to 1e-6 with each
step's tolerance anchored at step one's.  For each n one JSON line: the last
step's free-row residual and the final T's largest distance from a float64
solve to 1e-13 (of that T's largest) for float32 with AMG and with Jacobi
and for float64 with AMG, and each run's iterations.  The mass term M/dt
is about h²/dt of the stiffness, so float32 keeps fewer of its digits as h
falls; where the float32 error is the same with either preconditioner, the
solver is not what sets it.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..fem.bcs import BoundaryConditions, DirichletBC
from ..mesh.generate import rect_tria_mesh
from ..models import heat
from ..solver.linear_system import SolverOptions

STEPS = 10
DT = 0.1


def config(preconditioner: str = "amg", rtol: float = 1e-6) -> heat.HeatConfig:
    """T2 (a)'s heat configuration (tmax 9.5 dt: the loop runs while t < tmax;
    max_iter leaves room for Jacobi-CG at 1414²)."""
    return heat.HeatConfig(
        lam=1.0, qdot=1.0, dt=DT, tmax=(STEPS - 0.5) * DT,
        bcs=BoundaryConditions(dirichlet=[DirichletBC("left", value=0.0)]),
        convection=[heat.ConvectionBC("right", 2.0, 0.5)],
        solver=SolverOptions(method="cg", preconditioner=preconditioner, rtol=rtol,
                             max_iter=50_000, fail_action="raise"))


def measure(n: int, device: str) -> dict:
    mesh = rect_tria_mesh(n, n)
    ref = heat.solve(mesh, config(rtol=1e-13), device=device).T
    scale = float(np.abs(ref).max())
    line = {"n": n, "n_nodes": int(mesh.n_nodes), "device": device}
    for dtype, prec in ((torch.float32, "amg"), (torch.float32, "jacobi"),
                        (torch.float64, "amg")):
        r = heat.solve(mesh, config(prec), dtype=dtype, device=device)
        name = f"{str(dtype).split('.')[1]}_{prec}"
        line[name] = {"free_residual": r.info["free_residual"],
                      "field_error": float(np.abs(r.T.astype(np.float64) - ref).max() / scale),
                      "iterations": r.iterations}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[100, 200, 400])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("heat_floor: no CUDA device (--device cpu runs on the CPU)")
        return 1
    for n in args.n:
        print(json.dumps(measure(n, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
