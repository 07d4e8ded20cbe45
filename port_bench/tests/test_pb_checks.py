"""The check decides: a sound run at a small size on the CPU is correct,
while the control (the reference in float8 in the program's place) and
each fault planted under the timed path are not.  These drive the rest of
a run (``run.measure``) without the look for a card."""

import pytest

from port_bench import faults, judge, manifest, run
from port_bench.tests.small import small_root

TRAIN_CELLS = ["seg_h64i6-event_train", "hit_h64i7-event_train",
               "seg_h64i6-sector_train_blocked"]
INFER_CELLS = ["seg_h64i6-event_infer_b16"]
SEED = 2**31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("small"))


def _measure(root, workload, fault=None):
    cell = manifest.load_cell(workload, root)
    if fault is None:
        return run.measure(cell, SEED, 0.2, False, "cpu", "cpu")
    with faults.planted(fault):
        return run.measure(cell, SEED, 0.2, False, "cpu", "cpu")


@pytest.mark.parametrize("workload", TRAIN_CELLS + INFER_CELLS)
def test_a_sound_run_is_correct(root, workload):
    out = _measure(root, workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload, fault",
                         [(w, f) for w in TRAIN_CELLS for f in faults.TRAIN]
                         + [(w, f) for w in INFER_CELLS for f in faults.INFER])
def test_a_planted_fault_is_not_correct(root, workload, fault):
    out = _measure(root, workload, fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAIN_CELLS + INFER_CELLS)
def test_the_control_is_not_correct(root, workload):
    cell = manifest.load_cell(workload, root)
    s = run.session(cell, SEED, "cpu")
    if cell.traffic["driver"] == "train":
        numbers = s.check(program_run=s.control("float8_e4m3"))
    else:
        s.window(0.2)
        numbers = s.check(cell.limits, "float8_e4m3")[0]
    assert not judge.verdict(numbers, cell.limits)[0], numbers
