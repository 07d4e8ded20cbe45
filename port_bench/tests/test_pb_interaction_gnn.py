"""The Interaction Network's family (``families/interaction_gnn.py``,
``builders/interaction_gnn.py``), its cell and the three metrics that
read it (``gather_pair_roofline.train``, ``gather_pair_bwd_roofline.train``,
``layernorm_share.train``), on the CPU."""

import json

import pytest
import torch

from port_bench import gen, manifest, program, readers, reference, yardstick
from port_bench.tests.small import EVENTS
from port_bench.tracing import SPAN, Op, Trace

CELL = "ign_h128i8-event_train"
MS = 1_000_000       # ns


def _config(f32=False) -> dict:
    cfg = json.loads((manifest.HERE / "configs" / "ign_h128i8.json")
                     .read_text())
    cfg["events"].update(EVENTS)
    if f32:
        cfg["compute_dtype"] = "float32"
    return cfg


def test_forward_flops_of_the_cell():
    # v = 15,840, e = 180,576, h = 128, f = 2, 3 layers an MLP, 8
    # iterations: node encoder 2v(fh + 2h^2) = 1,046,446,080; edge
    # encoder 2e(2h^2 + 2h^2) = 23,669,604,352; an iteration's node
    # network 2v(2h^2 + 2h^2) = 2,076,180,480, edge network 2e(3h^2 +
    # 2h^2) = 29,587,005,440 and sum 2eh = 46,227,456; head 2e(3h^2 +
    # 2h^2 + h) = 29,633,232,896
    cfg = _config()
    fwd = manifest.family("interaction_gnn").forward_flops(cfg, 15_840,
                                                            180_576)
    assert fwd == 308_010_295_296.0
    assert yardstick.train_step_flops(fwd) == 924_030_885_888.0


def test_the_family_reads_the_published_widths():
    cfg = _config()
    leaves = manifest.family("interaction_gnn").leaves(cfg)
    assert sum(torch.Size(s).numel() for _, s, _ in leaves) == 333_825
    shapes = {n: s for n, s, _ in leaves}
    assert shapes["edge_network.0.weight"] == (128, 384)
    assert shapes["output_edge_classifier.9.weight"] == (1, 128)


def test_the_model_holds_the_references_weights_and_logits():
    """The port in float32 against the plain reference at a small size:
    the same sums in another order, so 1e-5."""
    cfg = _config(f32=True)
    mix = {"layout": "packed", "route": "pallas"}
    rngs, wseed = gen.streams(2**31 + 11, 1)
    ev = gen.make_event(cfg["events"], rngs[0])
    (batch,) = program.one_signature([program.layout([ev], cfg["events"],
                                                     mix)])
    w = reference.make_weights(cfg, wseed, "cpu")
    model = program.make_model(cfg, mix, w, "cpu")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: s for n, s, _ in manifest.family("interaction_gnn").leaves(cfg)}
    with torch.no_grad():
        got = model(batch)[:ev.n_edge]
    want = reference.logits(w, reference.graph_tensors(ev.packed(), "cpu"),
                            cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_kernel_shapes_of_the_cell():
    cell = manifest.load_cell(CELL)
    cfg = dict(cell.config, events=dict(cell.config["events"], **EVENTS))
    events = [gen.make_event(cfg["events"], r)
              for r in gen.streams(2**31 + 5, 2)[0]]
    batches = program.one_signature(
        [program.layout([e], cfg["events"], cell.traffic) for e in events])
    assert program.kernel_shapes(batches[0], cfg) == dict(
        v=512, e=4096, d=128, hdim=128, dtype_bytes=2)


# ---------------------------------------------------------------------------
# The readers, on traces built by hand
# ---------------------------------------------------------------------------

SHAPES = dict(v=15_848, e=180_736, d=128, hdim=128, dtype_bytes=2)
GATHER = ("void (anonymous namespace)::gather_pair_kernel<gnn::Vec<"
          "__nv_bfloat16, 8> >(long, int, int, int)")
SUM = ("void gnn::segment_rows_kernel<__nv_bfloat16, 8, 1, false>(int, "
       "int, int, int)")
WEIGHTED = ("void gnn::segment_rows_kernel<__nv_bfloat16, 8, 1, true>(int, "
            "int, int, int)")
LN_FWD = ("void at::native::(anonymous namespace)::vectorized_layer_norm_"
          "kernel<c10::BFloat16, float, false>(int, float)")
LN_BWD = ("void at::native::(anonymous namespace)::layer_norm_grad_input_"
          "kernel_vectorized<c10::BFloat16, float, false>()")
GAMMA = ("void at::native::(anonymous namespace)::GammaBetaBackwardCUDA"
         "KernelTemplate<c10::BFloat16, float, 32u, 1u, 32u, true, true, "
         "false>(long, long)")


def _slice(device, launches, kind="train"):
    """A 10 ms window whose device operations are ``device``: ``(name,
    start ms, end ms)``."""
    window = (0, 10 * MS)
    ops = [Op(n, int(a * MS), int(b * MS)) for n, a, b in device]
    return readers.Slice(
        trace=Trace(window, ops, [Op(SPAN, *window)]), kind=kind, units=64,
        useful_flops=0.0, launches=launches, shapes=SHAPES,
        peaks=yardstick.peaks("NVIDIA H100 80GB HBM3"), capture_s=None,
        kernels=manifest.kernel_patterns())


def _read(metric, s):
    return manifest.metric_reader(metric)(s)


def test_gather_pair_roofline_by_hand():
    # 4 launches in 0.1 ms: 25 us a call against 55,828,480 bytes
    # (2 tables of 15,848 x 128 bf16, 8 bytes of ids and a 256-byte row
    # an edge) at 3,350 GB/s, 16.665 us: 66.66%
    s = _slice([(GATHER, 1.0, 1.04), (GATHER, 2.0, 2.06),
                ("nvjet_tst_128x160", 3.0, 5.0)], {"gather_pair": 4})
    nbytes = yardstick.kernel_work("gather_pair", 2, 15_848, 180_736, 128,
                                   128)[0]
    assert nbytes == 55_828_480
    want = 100 * nbytes / 3350e9 / 25e-6
    assert _read("gather_pair_roofline.train", s) == pytest.approx(want)
    assert want == pytest.approx(66.66, abs=0.01)


def test_gather_pair_bwd_roofline_counts_both_wrappers():
    # 2 gather_pair_bwd and 3 edge_sum launches share the unweighted
    # kernel, 0.2 ms in all: 40 us a call; the weighted instance is not
    # this kernel
    s = _slice([(SUM, 1.0, 1.12), (SUM, 2.0, 2.08), (WEIGHTED, 3.0, 4.0)],
               {"gather_pair_bwd": 2, "edge_sum": 3})
    nbytes = yardstick.kernel_work("gather_pair_bwd", 2, 15_848, 180_736,
                                   128, 128)[0]
    want = 100 * nbytes / 3350e9 / 40e-6
    assert _read("gather_pair_bwd_roofline.train", s) == pytest.approx(want)


def test_layernorm_share_by_hand():
    # the LayerNorm kernels run 2 ms of the 4 ms in which the device is
    # busy
    s = _slice([(LN_FWD, 0.0, 1.0), (LN_BWD, 1.0, 1.5), (GAMMA, 1.5, 2.0),
                ("nvjet_tst_128x160", 2.0, 4.0)], {})
    assert _read("layernorm_share.train", s) == pytest.approx(50.0)


@pytest.mark.parametrize("metric", ["gather_pair_roofline.train",
                                    "gather_pair_bwd_roofline.train",
                                    "layernorm_share.train"])
def test_a_reader_with_nothing_to_read_is_none(metric):
    """A program without the kernels or the counters (a cell of another
    model), or a scoring slice."""
    nothing = _slice([("nvjet_tst_128x160", 1.0, 2.0)],
                     {"gather_pair": 0, "gather_pair_bwd": 0})
    assert _read(metric, nothing) is None
    scoring = _slice([(GATHER, 1.0, 1.1), (SUM, 2.0, 2.1),
                      (LN_FWD, 3.0, 3.1)],
                     {"gather_pair": 1, "gather_pair_bwd": 1}, kind="infer")
    assert _read(metric, scoring) is None


# ---------------------------------------------------------------------------
# The check, at a small size on the CPU (as test_pb_checks.py for the
# other cells)
# ---------------------------------------------------------------------------

SEED = 2**31 + 101


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from port_bench.tests.small import small_root

    return small_root(tmp_path_factory.mktemp("small"))


def test_a_sound_run_is_correct_and_the_control_is_not(root):
    from port_bench import judge, run

    cell = manifest.load_cell(CELL, root)
    out = run.measure(cell, SEED, 0.2, False, "cpu", "cpu")
    assert out["correct"], out["checks"]
    s = run.session(cell, SEED, "cpu")
    numbers = s.check(program_run=s.control("float8_e4m3"))
    assert not judge.verdict(numbers, cell.limits)[0], numbers


def test_an_unchanged_state_is_not_correct(root):
    from port_bench import faults, run

    cell = manifest.load_cell(CELL, root)
    with faults.planted("unchanged"):
        out = run.measure(cell, SEED, 0.2, False, "cpu", "cpu")
    assert not out["correct"], out["checks"]


def test_the_builder_takes_the_pallas_route_alone():
    cfg = _config()
    with pytest.raises(ValueError, match="pallas route"):
        manifest.builder("interaction_gnn").make_model(
            cfg, {"route": "blocked"}, "cpu")
