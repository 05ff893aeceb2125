"""Published peaks of one NVIDIA H100 and the frozen least-bytes counts.

Peaks (NVIDIA's data sheet, SXM part, at its full 700 W): 3.35 TB/s of
HBM bandwidth and 67 TFLOP/s in float32 outside the tensor cores.  A
share is stated against them with the card's ``power.limit`` beside it.

The least bytes of an operation are what any implementation of it must
move, counted from the problem's sizes and not from a kernel's traffic:
each input read once, each output written once.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# lhs assembly of P1 tetrahedra: float32 coordinates read (3 x 4 B per
# node), int32 connectivity read (4 x 4 B per cell), float32 values
# written (4 B per stored nonzero)
ASM_BYTES_PER_NODE = 12
ASM_BYTES_PER_CELL = 16
ASM_BYTES_PER_NNZ = 4


def asm_least_bytes(n_nodes: int, n_cells: int, nnz: int) -> int:
    """Least bytes of one lhs assembly."""
    return (ASM_BYTES_PER_NODE * n_nodes + ASM_BYTES_PER_CELL * n_cells
            + ASM_BYTES_PER_NNZ * nnz)


def least_seconds(nbytes: float = 0.0, flops: float = 0.0) -> float:
    """The larger of the byte bound and the float32 flop bound."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def power_limit() -> str | None:
    """The card's ``name, power.limit`` as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
