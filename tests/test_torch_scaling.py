"""The port's scaling harness (``gnn_fpga_tpu_torch/probes/scaling.py``)
on the CPU: ``run_mode`` in gloo worlds of spawned ranks reports every
count, marked as timing the mechanics only (the cases of
``tests/test_bench_scaling.py``); ``comm_model``'s halo sizes equal the
JAX ``partition_graph``'s, it counts ``4 * n_iters + 2`` collectives a
step, prints no overlap figure, and refuses a card it has no link rate
for."""

import numpy as np
import pytest
import torch

import bench_scaling
from gnn_fpga_tpu.parallel import partition as jpartition
from gnn_fpga_tpu_torch.probes import scaling

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several
    workers on the machine's cores, and the tiny ops here only slow down
    with more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode,counts", [("dp", [1, 2]),
                                         ("partitioned", [1, 4])])
def test_run_mode_reports_every_count_as_mechanics_only(mode, counts):
    res = scaling.run_mode(mode, counts, n_steps=2, hidden=8, n_iters=2,
                           n_tracks=4, batch=2, device="cpu")
    assert set(res) == set(counts)
    for n, v in res.items():
        assert v["edges_per_s"] > 0
        assert v["edges_per_s_per_chip"] == pytest.approx(
            v["edges_per_s"] / n)
        assert v["mechanics_only"] and v["backend"] == "gloo"


def test_scaling_main_prints_no_efficiency_for_mechanics(capsys):
    recs = scaling.main(["--mode", "dp", "--device-counts", "1",
                         "--steps", "2", "--hidden", "8", "--n-iters", "2",
                         "--n-tracks", "4", "--batch", "2", "--device",
                         "cpu"])
    assert len(recs) == 1
    assert recs[0]["value"] is None and recs[0]["mechanics_only"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "# device: cpu")


@pytest.fixture(scope="module")
def model_records():
    return scaling.comm_model(3.0, [2, 4], hidden=64, n_iters=6, card=H100)


def test_comm_model_halo_sizes_equal_the_jax_partition(model_records):
    graphs = {"sectors": bench_scaling._fullevent_graph(),
              "connected": bench_scaling._connected_fullevent_graph()}
    assert [r["metric"] for r in model_records] == [
        f"comm_model_partitioned_fullevent_{k}" for k in graphs]
    for rec, g in zip(model_records, graphs.values()):
        for p in (2, 4):
            assert rec["per_device_counts"][str(p)]["halo_size"] == \
                jpartition.partition_graph(g, p).halo_size


def test_comm_model_counts_4n_plus_2_collectives_and_no_overlap(
        model_records):
    for rec in model_records:
        assert rec["collectives_per_step"] == 4 * 6 + 2
        assert rec["link_gbps_per_direction"] == 450.0
        assert rec["device_kind"] == H100
        for p, v in rec["per_device_counts"].items():
            p = int(p)
            want = (p - 1) * v["halo_size"] * (64 + 2) * 2 * (4 * 6 + 2)
            assert v["comm_mb_per_step_per_dev"] == pytest.approx(want / 1e6)
            assert v["t_comm_ms"] == pytest.approx(want / 450e9 * 1e3)
            assert v["t_comp_ms"] == pytest.approx(3.0 / p)
            assert "eff_overlap" not in v
            assert 0 < v["eff_no_overlap"] <= 1
    assert np.all([scaling.n_collectives(n) == 4 * n + 2 for n in range(8)])


def test_comm_model_refuses_an_unknown_card():
    with pytest.raises(ValueError, match="no link rate"):
        scaling.comm_model(3.0, [2], card="NVIDIA A100-SXM4-80GB")
