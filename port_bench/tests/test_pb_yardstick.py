"""The frozen counts, pinned at hand-worked values and held to the
program's own where it has them."""

import json

import pytest

from gnn_fpga_tpu_torch.utils import flops as program_flops
from port_bench import manifest, yardstick


def _config(name: str) -> dict:
    return json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())


def _forward_flops(name: str, n_node: float, n_edge: float) -> float:
    """The forward count of configuration ``name``'s model family."""
    cfg = _config(name)
    return manifest.family(cfg["model"]).forward_flops(cfg, n_node, n_edge)


def test_segment_classifier_step_of_the_event_cells():
    # v = 15,840, e = 180,576, h = 64, d = 66, 6 iterations:
    # edge MLP 2 e h (2d + 1) = 3,074,125,824; node MLP 2 v h (3d + h) =
    # 531,210,240; aggregation 4 e d = 47,672,064; input 2 v 2 h =
    # 4,055,040; forward 24,996,229,632; a step three forwards
    step = yardstick.train_step_flops(
        _forward_flops("seg_h64i6", 15_840, 180_576))
    assert step == 74_988_688_896.0


def test_node_classifier_step_of_the_hit_cell():
    # v = 15,840, e = 331,056, h = 64, d = 67, 7 iterations:
    # edge MLP 5,720,647,680; node MLP 2 v h (3d + h) = 537,292,800;
    # aggregation 88,723,008; input 6,082,560; output 2 v d = 2,122,560;
    # forward 44,434,849,536
    step = yardstick.train_step_flops(
        _forward_flops("hit_h64i7", 15_840, 331_056))
    assert step == 133_304_548_608.0


@pytest.mark.parametrize("name, e, d, want", [
    # 4 tables of 64 and 4 of 66 bf16 columns on 15,848 rows, 12 bytes an
    # edge (weight, sender, receiver)
    ("iteration_pair_bwd", 180_736, 66, 18_650_752),
    # 2 tables of 64 and 3 of 66 columns, 12 bytes an edge
    ("iteration_pair", 180_736, 66, 12_501_728),
    ("iteration_pair_bwd", 331_264, 67, 20_583_872),
    ("iteration_pair", 331_264, 67, 14_403_152),
])
def test_kernel_bytes(name, e, d, want):
    assert yardstick.kernel_work(name, 2, 15_848, e, d, 64)[0] == want


@pytest.mark.parametrize("name", ["iteration_pair", "aggregate_pair",
                                  "gather_pair", "iteration_pair_bwd",
                                  "aggregate_pair_bwd", "gather_pair_bwd"])
def test_frozen_copy_agrees_with_the_program(name):
    for args in ((2, 15_848, 180_736, 66, 64), (4, 100, 1_000, 67, 64)):
        assert yardstick.kernel_work(name, *args) == \
            program_flops.kernel_work(name, *args)
    assert _forward_flops("seg_h64i6", 100, 1000) == \
        program_flops.segment_classifier_flops(100, 1000, 64, 6, 2)
    assert yardstick.PEAKS["NVIDIA H100 80GB HBM3"].bf16_tflops == 989.5
