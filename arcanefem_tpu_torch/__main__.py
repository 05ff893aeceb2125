"""CLI: run reference .arc cases on one CUDA card.

The counterpart of ``python -m arcanefem_tpu run``: dispatches on the
case's codename as the reference's per-module executables do.

    python -m arcanefem_tpu_torch run case.arc [--f32] [--no-check]
                                     [--mesh-root DIR] [--device cuda|cpu]
                                     [--output-dir DIR]

The case runs on ``--device`` (default ``cuda``, the card).  Nothing falls
back: without a CUDA device the command exits 1 unless ``--device cpu``
asks for the CPU.  ``--output-dir`` writes the case's
``<arcane-post-processing>`` variables there: a VTKHDF file where h5py can
be imported, legacy VTK where it cannot; a transient heat case writes one
temporal VTKHDF file, one step per time step.

    python -m arcanefem_tpu_torch testlab [--mesh F | --box N | --rect N]
                                     [--formats a,b] [--cache-warming K]
                                     [--json PATH] [--cross-validate]
                                     [--f64] [--device cuda|cpu]

runs the assembly-format laboratory (``testlab.py::main``) under the same
rule: ``--device`` defaults to ``cuda``, without CUDA it exits 1 unless
``--device cpu``, and ``--f64`` picks the dtype alone.
"""

from __future__ import annotations

import argparse
import sys

def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(prog="arcanefem_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a reference .arc case")
    runp.add_argument("case")
    runp.add_argument("--f32", action="store_true", help="float32 system")
    runp.add_argument("--no-check", action="store_true",
                      help="skip golden-file validation")
    runp.add_argument("--mesh-root", default=None)
    runp.add_argument("--device", default="cuda",
                      help="torch device of the run (default: cuda)")
    runp.add_argument("--output-dir", default=None,
                      help="write the case's post-processing variables here "
                           "(VTKHDF, or legacy VTK without h5py)")

    sub.add_parser("testlab", add_help=False,
                   help="the assembly-format laboratory (testlab --help)")

    if argv and argv[0] == "testlab":
        from .testlab import main as testlab_main

        return testlab_main(argv[1:])

    args = p.parse_args(argv)

    import torch

    from .fem.runner import run_case

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("arcanefem_tpu_torch: no CUDA device is available; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 1

    res = run_case(
        args.case,
        dtype=torch.float32 if args.f32 else torch.float64,
        mesh_root=args.mesh_root,
        check=not args.no_check,
        verbose=True,
        output_dir=args.output_dir,
        device=device,
    )
    info = {
        k: v for k, v in vars(res).items()
        if isinstance(v, (int, float, str))
    }
    print(f"done: {type(res).__name__} {info}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
