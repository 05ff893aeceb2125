"""Layer: kernels (tet_element, slot_reduce).  The assembly's least time
(its least bytes at the HBM peak, roofline.py) over the device time per
assembly in the traced segment, in %.  Moves assembly_mdofs."""

from benchmark import roofline


def read(ctx):
    tr = ctx.get("trace")
    if ctx["window"]["kind"] != "stream" or not tr or tr["busy_s"] <= 0 or not tr["units"]:
        return None
    least = roofline.least_seconds(roofline.asm_least_bytes(
        ctx["n_dofs"], ctx["n_cells"], ctx["nnz"]))
    return 100.0 * least / (tr["busy_s"] / tr["units"])
