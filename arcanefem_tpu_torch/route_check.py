"""Iteration counts and residuals of the sphere's solver routes.

    python -m arcanefem_tpu_torch.route_check --h 8 --refine 1 [--device cpu]

solves the bench system of ``bench_unstructured`` (float32, penalty 1e12)
on the ELL route and then on each route that ``chip_smoke.py``'s phases 9
and g-i run, reusing one operator and AMG hierarchy, and prints one JSON line
per route: iterations, monitored and true residual.  It times nothing:
iteration counts and residuals do not depend on the device, so
``--device cpu`` gives them at sizes the CPU can hold, for A/Bs and
predictions before a run on the card (the role of the JAX package's
``tools/conv_tune.py``).  Without ``--device`` it runs on the card.
"""

from __future__ import annotations

import argparse
import json

import torch

from .bench_unstructured import solve_sphere_cut, sphere_cut_system

ROUTES = {
    "ell": {},
    "a": dict(spmv="supernode"),
    "b": dict(spmv="supernode", sn_block=True),
    "c": dict(spmv="supernode", sn_block=True, sn_bf16=True),
    "d": dict(sn_block=True),
    "e": dict(vcycle_bf16=True),
    "f": dict(asm_coords="batched"),
    "g": dict(spmv="compact"),
    "h": dict(spmv="compact", band_pre=True),
    "i": dict(spmv="compact", band_pre=True, asm_compact=True, asm_coords="batched"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=float, default=8.0)
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu for the CPU")
    mesh, topo = sphere_cut_system(args.h, args.refine, cache=False)
    system = None
    for name, opts in ROUTES.items():
        r = solve_sphere_cut(mesh, topo, device=args.device,
                             dtype=torch.float32, penalty=1e12,
                             system=system, **opts)
        system = r["system"]
        print(json.dumps({"route": name, "flags": opts, "n_dofs": topo.n_nodes,
                          "device": args.device, "iterations": r["iterations"],
                          "rel": r["rel"], "true_residual": r["true_residual"]}),
              flush=True)


if __name__ == "__main__":
    main()
