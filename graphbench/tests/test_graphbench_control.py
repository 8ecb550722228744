"""The control (the reference in the program's place, with the guarantee
broken) comes out not correct under each cell's limits, at a size a test
run holds; on the card at the cell's size ``graphbench/control.py`` reads
it."""

import pytest

from graphbench import control, manifest


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
@pytest.mark.parametrize("cell", manifest.names("workloads"))
def test_control_is_not_correct(cell, seed, tiny):
    out = control.read_control(cell, seed, "cpu", overrides=tiny[cell])
    assert out["correct"] is False, out
