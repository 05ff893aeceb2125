"""The frozen least-bytes count of the assembly and the published peaks."""

import numpy as np
import pytest

from benchmark import core, roofline


def test_two_tet_mesh_hand_count():
    # tets (0,1,2,3) and (1,2,3,4) share the face (1,2,3): rows 0 and 4
    # have 4 entries each, rows 1-3 all 5: 23 stored nonzeros
    tets = np.array([[0, 1, 2, 3], [1, 2, 3, 4]])
    pairs = {(int(a), int(b)) for t in tets for a in t for b in t}
    assert len(pairs) == 23
    assert roofline.asm_least_bytes(5, 2, 23) == 12 * 5 + 16 * 2 + 4 * 23 == 184


def test_least_time_and_a_share_under_100():
    assert roofline.HBM_BYTES_PER_S == 3.35e12 and roofline.F32_FLOP_PER_S == 67e12
    b = roofline.asm_least_bytes(1_892_689, 10_982_208, 27_894_865)
    assert b == 12 * 1_892_689 + 16 * 10_982_208 + 4 * 27_894_865 == 310_007_056
    assert roofline.least_seconds(b) == pytest.approx(b / 3.35e12)
    read = core.module("metrics", "asm_roofline").read
    ctx = {"window": {"kind": "stream"}, "n_dofs": 1_892_689, "n_cells": 10_982_208,
           "nnz": 27_894_865, "trace": {"busy_s": 1.14e-3 * 100, "window_s": 0.2,
                                       "units": 100}}
    assert read(ctx) == pytest.approx(100 * b / 3.35e12 / 1.14e-3)
    assert 0 < read(ctx) < 100
