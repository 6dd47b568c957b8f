"""The control (the reference in TF32 in the program's place) and the
faults planted in the reference fail each cell's limits, at a size the
CPU holds (``renderbench/control.py`` reads them on the card at the
cells' own sizes)."""

import pytest
import torch

from renderbench import check, control, manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_fail_the_limits(cell, tiny):
    limits = manifest.cell(manifest.load(), cell)["limits"]
    got = control.readings(cell, 2**31 + 3, torch.device("cpu"), 4, tiny)
    assert set(got) >= {"control", "half", "altered"}
    for name, readings in got.items():
        ok, _ = check.verdict(readings, limits)
        assert not ok, (name, readings)
