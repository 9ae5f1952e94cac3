"""The comparison catches a broken timed path: each fault a training cell
can have, planted under a CPU run at a tiny size, turns ``correct``
false under the cell's own limits, while the same run unbroken passes.
The gang case runs two gloo ranks on the CPU."""

import pytest

import run
from benchlib import compare, report, spec
from tiny import CELLS, SEED

ONE_CHIP = ["bert-base-mlm.s512-b96", "resnet50-imagenet.i224-b256"]
DP = "resnet50-imagenet.i224-b256-dp4"


def _correct(cell: str, fault: str | None) -> bool:
    code, result = run.run_cell(cell, SEED, 0.2, False, device="cpu",
                                fault=fault, tiny=CELLS[cell])
    assert code == 0
    return result["correct"]


@pytest.mark.parametrize("cell", ONE_CHIP + [DP])
def test_sound_run_is_correct(cell):
    assert _correct(cell, None)


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
@pytest.mark.parametrize("cell", ONE_CHIP + [DP])
def test_fault_is_caught(cell, fault):
    assert not _correct(cell, fault)


def test_missing_exchange_is_caught():
    assert not _correct(DP, "no_exchange")


@pytest.mark.parametrize("cell", ONE_CHIP + [DP])
def test_control_fails(cell):
    """The control, the reference computed in fp8 (reference/common.py
    ``Ops``) in the program's place, fails the cell's limits against
    the f32 reference."""
    tiny = CELLS[cell]
    work = {**spec.workload(cell), **tiny["work"]}
    tr = {**spec.traffic(work["traffic"]), **tiny["traffic"]}
    cfgfile = spec.config(work["config"])
    from benchlib import cell as cell_lib
    exp = cell_lib.build_config(cfgfile, work, tr, tiny["extra"]).to_dict()
    chips = int(work["chips"])
    truth = report.reference_readings(cfgfile, tr, exp, SEED, chips, "cpu")
    control = report.reference_readings(cfgfile, tr, exp, SEED, chips,
                                        "cpu", quant="fp8")
    ok, checks = compare.decide(compare.gaps(control, truth),
                                work["limits"])
    assert not ok, checks
