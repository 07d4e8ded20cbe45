"""``gnn_fpga_tpu_torch/utils/flops.py`` against the JAX package's
``utils/flops.py``, on the CPU: the useful-FLOP counts float for float,
the peaks (None off a known card, the data sheet's for an H100 name),
and the fused step's roofline as the sum of its launches' work."""

import itertools

import pytest
import torch

from gnn_fpga_tpu.utils import flops as jflops
from gnn_fpga_tpu_torch.utils import flops as tflops

H100_SXM = "NVIDIA H100 80GB HBM3"
# the fullevent configuration (bench.py:228-311): 36 sectors packed
V, E, HID, ITERS, IN = 15_848, 180_736, 64, 6, 2
D = HID + IN


@pytest.fixture
def card(monkeypatch):
    """``torch.cuda.get_device_name`` answering ``card.name`` for any
    CUDA device (no card is needed: only the name is read)."""

    class Card:
        name = H100_SXM

    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: Card.name)
    return Card


@pytest.mark.parametrize("n_node,n_edge,hidden,iters,input_dim", list(
    itertools.product((1, 440, 15_840), (0, 5_280, 180_576), (8, 64),
                      (1, 6), (2, 3))))
def test_useful_flops_equal_jax(n_node, n_edge, hidden, iters, input_dim):
    got = tflops.segment_classifier_flops(n_node, n_edge, hidden, iters,
                                          input_dim)
    want = jflops.segment_classifier_flops(n_node, n_edge, hidden, iters,
                                           input_dim)
    assert got == want and type(got) is type(want)
    assert tflops.train_step_flops(got) == jflops.train_step_flops(want)


def test_no_peaks_off_a_known_card(card):
    if not torch.cuda.is_available():
        for fn in (tflops.chip_peak_tflops, tflops.chip_hbm_gbps,
                   tflops.chip_peaks):
            assert fn() is None
        assert tflops.mfu(1e12) is None
    for device in ("cpu", torch.device("cpu")):
        assert tflops.chip_peak_tflops(device) is None
        assert tflops.chip_hbm_gbps(device) is None
        assert tflops.mfu(1e12, device) is None
        assert tflops.attainable(1.0, 1.0, 1.0, 1.0, device) == (None,) * 5
    card.name = "NVIDIA A100-SXM4-80GB"
    assert tflops.chip_peaks("cuda:0") is None
    assert tflops.mfu(1e12, "cuda:0") is None


def test_h100_peaks_are_the_data_sheet(card):
    """The SXM part: 1,979 TFLOP/s bf16 with sparsity (989.5 dense), 67
    f32, 34 f64, 3.35 TB/s; the PCIe part: 1,513 (756.5), 51, 26, 2 TB/s."""
    for device in ("cuda:0", 0, torch.device("cuda", 0)):
        assert tflops.chip_peak_tflops(device) == 989.5
        assert tflops.chip_hbm_gbps(device) == 3350.0
    peaks = tflops.chip_peaks("cuda")
    assert (peaks.f32_tflops, peaks.f64_tflops) == (67.0, 34.0)
    assert tflops.mfu(989.5e12 / 4, "cuda") == 0.25
    card.name = "NVIDIA H100 PCIe"
    assert tflops.chip_peaks("cuda") == tflops.ChipPeaks(756.5, 51.0, 26.0,
                                                         2000.0)


def test_kernel_work_gives_the_kernel_tables_bounds():
    """The bytes of #1 and #3 at the fullevent shapes over 3.35 TB/s are
    the kernel table's bounds (PERF.md): 3.7 / 6.8 and 5.6 / 10.5 us in
    bf16 / f32."""
    rate = 3350e9
    us = lambda name, t: tflops.kernel_work(name, t, V, E, D, HID)[0] \
        / rate * 1e6
    assert [round(us("iteration_pair", t), 1) for t in (2, 4)] == [3.7, 6.8]
    assert [round(us("iteration_pair_bwd", t), 1) for t in (2, 4)] == \
        [5.6, 10.5]
    assert tflops.kernel_work("iteration_pair", 2, V, E, D, HID)[1] == \
        E * (6 * HID + 4 * D + 4)


def test_edge_sum_work_is_the_bwd_kernels_and_the_add():
    """``edge_sum`` at the Interaction Network's width: #5's bytes and
    operations, then its two ``[V, H]`` halves read and their sum written
    (one add a node and column)."""
    h = 128
    kern = tflops.kernel_work("gather_pair_bwd", 2, V, E, h, h)
    got = tflops.kernel_work("edge_sum", 2, V, E, h, h)
    assert got == (kern[0] + 3 * V * h * 2, kern[1] + V * h)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_layer_norm_relu_work_reads_and_writes_the_rows_once(dtype_bytes):
    """The fused pair at the Interaction Network's edge rows (E = 180,736,
    H = 128): forward the rows read and written once and 8 bytes of
    statistics a row, 94 MB in bf16; backward two reads and a write, 140
    MB; both bound by bytes, not by their f32 operations."""
    h, rows = 128, 180_736
    fwd = tflops.kernel_work("layer_norm_relu", dtype_bytes, V, rows, h, h)
    bwd = tflops.kernel_work("layer_norm_relu_bwd", dtype_bytes, V, rows, h,
                             h)
    row = rows * h * dtype_bytes
    assert fwd[0] == 2 * row + 8 * rows + 3 * h * dtype_bytes
    assert bwd[0] == 3 * row + 8 * rows + 6 * h * dtype_bytes
    if dtype_bytes == 2:
        assert (round(fwd[0] / 1e6), round(bwd[0] / 1e6)) == (94, 140)
    peaks = tflops._PEAKS["NVIDIA H100 80GB HBM3"]
    for nbytes, ops in (fwd, bwd):
        assert nbytes / (peaks.hbm_gbps * 1e9) > ops / (peaks.f32_tflops
                                                         * 1e12)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_fused_step_cost_sums_its_launches(dtype_bytes):
    """At the fullevent shapes: the f32 operations and kernel bytes are
    the sum of kernel_work over a step's launches (6 of #1 and #3, one of
    #6 and #5); the tensor FLOPs and the rest of the bytes are the GEMMs',
    counted here by hand."""
    launches = tflops.fused_step_launches(ITERS)
    assert launches == {"iteration_pair": 6, "iteration_pair_bwd": 6,
                        "gather_pair": 1, "gather_pair_bwd": 1}
    k_bytes = sum(n * tflops.kernel_work(k, dtype_bytes, V, E, D, HID)[0]
                  for k, n in launches.items())
    k_ops = sum(n * tflops.kernel_work(k, dtype_bytes, V, E, D, HID)[1]
                for k, n in launches.items())
    tensor, f32, nbytes = tflops.fused_step_cost(E, V, HID, D, ITERS,
                                                 dtype_bytes)
    assert f32 == k_ops
    gemm = lambda m, k, n: (2 * m * k * n, (m * k + k * n + m * n)
                            * dtype_bytes)
    per_iter = [gemm(V, D, HID)] * 2 + [gemm(V, 3 * D, HID),
                                        gemm(V, HID, HID)]
    head = [gemm(V, D, HID)] * 2 + [gemm(E, HID, 1)]
    flops = 2 * gemm(V, IN, HID)[0] + 3 * (
        ITERS * sum(f for f, _ in per_iter) + sum(f for f, _ in head))
    gbytes = 2 * gemm(V, IN, HID)[1] + 3 * (
        ITERS * sum(b for _, b in per_iter) + sum(b for _, b in head))
    assert tensor == flops
    assert nbytes == k_bytes + gbytes
    assert tflops.fused_step_gemms(V, E, HID, D, ITERS, dtype_bytes) == (
        tensor, gbytes)


def test_attainable_names_the_wall(card):
    useful = tflops.train_step_flops(tflops.segment_classifier_flops(
        15_840, 180_576, HID, ITERS, IN))
    tensor, f32, nbytes = tflops.fused_step_cost(E, V, HID, D, ITERS)
    att, bound, t_tensor, t_f32, t_bytes = tflops.attainable(
        useful, tensor, f32, nbytes, "cuda")
    assert t_tensor == tensor / 989.5e12 and t_f32 == f32 / 67e12
    assert t_bytes == nbytes / 3350e9
    t = max(t_tensor, t_f32, t_bytes)
    assert bound == {t_tensor: "tensor", t_f32: "f32", t_bytes: "bytes"}[t]
    assert att == pytest.approx(useful / t / 989.5e12, rel=1e-12)
    assert 0 < att < 1
    # a step that is all GEMMs is bound by the tensor cores
    assert tflops.attainable(1.0, 1e12, 0.0, 0.0, "cuda")[1] == "tensor"
    assert tflops.attainable(1.0, 0.0, 1e12, 0.0, "cuda")[1] == "f32"


# The TPU probes' default shapes (benchmarks/probe_ops.py, probe_bw.py,
# probe_spmm_ablate.py; probe_iter.py with H = D)
PV, PE, PD = 16_384, 131_072, 128


def test_kernel_work_gives_the_probes_bytes():
    """The bytes the smoke printed for the TPU probe kernels before they
    were ported (the kernel table's rows 11, 13, 14): the backward from
    stashed scores 69.2 MB in f32, the passthrough 134.2 MB, the gather
    76.0 MB."""
    nbytes = lambda name, b: tflops.kernel_work(name, b, PV, PE, PD, PD)[0]
    assert nbytes("iteration_pair_bwd_stashed", 4) == \
        4 * (8 * PV * PD + 4 * PE + 2 * PD)
    assert nbytes("passthrough", 4) == 2 * PE * PD * 4
    assert nbytes("gather_rows", 4) == 4 * (PE + PV * PD + PE * PD)
    assert [round(nbytes(n, 4) / 1e6, 1) for n in (
        "iteration_pair_bwd_stashed", "passthrough", "gather_rows")] == \
        [69.2, 134.2, 76.0]
    # the recompute form reads b2 and no scores
    assert nbytes("iteration_pair_bwd_recompute", 4) == \
        nbytes("iteration_pair_bwd_stashed", 4) - 4 * PE + 4


def test_ablation_full_is_the_tpu_count_with_the_ports_output():
    """The TPU probe's 14.3 MB (bf16 h, three f32 or int32 values an edge,
    an f32 output of V + 1 rows rounded up to 8 plus a tile of 256) is the
    port's ``full`` with the TPU's output table in place of the port's
    (V rows in bf16) and the CSR offsets."""
    tpu_out = 4 * ((PV + 8) // 8 * 8 + 256) * PD
    tpu = 2 * PV * PD + 12 * PE + tpu_out
    assert round(tpu / 1e6, 1) == 14.3
    full = tflops.kernel_work("ablate_full", 2, PV, PE, PD, PD)[0]
    assert full == tpu - tpu_out + 2 * PV * PD + 4 * (PV + 1)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("v,e,d", [(PV, PE, PD), (V, E, D)])
def test_each_ablation_mode_counts_its_own_bytes(dtype_bytes, v, e, d):
    work = lambda mode, width=d: tflops.kernel_work(
        f"ablate_{mode}", dtype_bytes, v, e, width, width)
    row, groups = d * dtype_bytes, -(-e // 2048)
    assert work("full")[0] == 2 * v * row + 4 * (v + 1) + 12 * e
    assert work("no_gather")[0] == (256 + v) * row + 4 * (v + 1) + 8 * e
    assert work("no_scatter")[0] == (v + groups) * row + 12 * e
    assert work("compute")[0] == (256 + groups) * row + 8 * e
    assert work("ids_only") == (12 * e + 8 * groups, 2 * e)
    assert all(work(m)[1] == 2 * e * d
               for m in ("full", "no_gather", "no_scatter", "compute"))
    pitch = -(-d * dtype_bytes // 16) * 16 // dtype_bytes
    assert work("aligned") == work("full", pitch)
    if d == PD:
        assert work("aligned") == work("full")
