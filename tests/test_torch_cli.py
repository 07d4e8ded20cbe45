"""The port's train and infer CLIs against the JAX package's, on NPZ graphs
written by the JAX package's ``save_npz``: the training losses on the
dense (``auto``), blocked and pallas routes from the same initial
weights, resume numbering, ``model.npz`` crossed both ways through the
two infer CLIs, and the errors the CLI raises."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.cli import infer as jinfer
from gnn_fpga_tpu.cli import train as jtrain
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu_torch.cli import infer as tinfer
from gnn_fpga_tpu_torch.cli import train as ttrain
from gnn_fpga_tpu_torch.core import batching as tb
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.utils import serialization as tser

N_GRAPHS = 8
# 4 train graphs (2 batches), 2 valid, 2 test
COMMON = ["--n-samples", str(N_GRAPHS), "--batch-size", "2",
          "--hidden-dim", "8", "--n-iters", "2", "--valid-frac", "0.25",
          "--test-frac", "0.25", "--learning-rate", "3e-3",
          "--pos-weight", "2", "--seed", "3"]
# f32 training losses of the same steps: summation order only
LOSS_TOL = dict(rtol=1e-4)
# per-file mean scores of the same weights on the same graphs
SCORE_TOL = dict(rtol=1e-5)


@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    """Toy2D window-cut sector graphs (hits sorted by layer, variable edge
    counts) as NPZ files written by the JAX package, with ``layer``."""
    d = tmp_path_factory.mktemp("graphs")
    cfg = jtoy.Toy2DConfig(n_layers=6, n_tracks=3, seed=0)
    gs = jtoy.make_window_segment_graphs(cfg, N_GRAPHS, window=0.4)
    _, _, _, layers = jtoy.generate_events(cfg, N_GRAPHS)
    for i in range(N_GRAPHS):
        g = jax.tree.map(lambda a: np.asarray(a)[i], gs)
        jg.save_npz(g, str(d / f"g{i:03d}.npz"), layer=layers[i])
    return d


@pytest.fixture
def jax_init(monkeypatch):
    """The port's CLI model built with the JAX CLI's initial weights
    (``PRNGKey(seed)``), carried across."""
    init = tm.init_segment_classifier

    def from_jax(cfg, generator, device=None):
        model = init(cfg, generator, device)
        seed = generator.initial_seed()
        params = jm.init_segment_classifier(
            jax.random.PRNGKey(seed), jm.SegmentClassifierConfig(
                input_dim=cfg.input_dim, hidden_dim=cfg.hidden_dim,
                n_iters=cfg.n_iters))
        tser.load_jax_params(model, jax.tree.map(np.asarray, params))
        return model

    monkeypatch.setattr(tm, "init_segment_classifier", from_jax)


def _jax_train(args):
    with pltpu.force_tpu_interpret_mode():
        return jtrain.main(args)


@pytest.mark.parametrize("route,extra", [
    ("auto", []), ("blocked", ["--group", "2"]), ("pallas", [])])
def test_train_cli_matches_jax(graph_dir, tmp_path, jax_init, route, extra):
    args = ["--input-dir", str(graph_dir), "--n-epochs", "2",
            "--aggregation", route, *extra, *COMMON]
    want = _jax_train(args + ["--prefetch", "0"])
    got = ttrain.main(args + ["--device", "cpu", "--output-dir",
                              str(tmp_path / "run")])
    assert len(got.train_losses) == 2
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               **LOSS_TOL)
    np.testing.assert_allclose(got.valid_losses, want.valid_losses,
                               **LOSS_TOL)
    with np.load(tmp_path / "run" / "losses.npz") as f:
        assert sorted(f.files) == ["train_losses", "valid_losses"]
        np.testing.assert_array_equal(f["train_losses"], got.train_losses)


def test_train_cli_resumes_epoch_numbering(graph_dir, tmp_path):
    args = ["--input-dir", str(graph_dir), "--output-dir", str(tmp_path),
            "--aggregation", "pallas", "--device", "cpu", *COMMON]
    first = ttrain.main(args + ["--n-epochs", "2"])
    second = ttrain.main(args + ["--n-epochs", "1", "--resume",
                                 "--prefetch", "0"])
    assert second.epoch == 3
    assert second.train_losses[:2] == first.train_losses
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
    with np.load(tmp_path / "losses.npz") as f:
        assert len(f["train_losses"]) == 3


def _scores(results):
    return [r["mean_score"] for r in results]


def test_model_npz_crosses_both_infer_clis(graph_dir, tmp_path):
    """A model.npz written by either package's train CLI gives the same
    per-file scores in both infer CLIs."""
    train = ["--input-dir", str(graph_dir), "--n-epochs", "1", *COMMON]
    jtrain.main(train + ["--output-dir", str(tmp_path / "jax"),
                         "--prefetch", "0"])
    ttrain.main(train + ["--output-dir", str(tmp_path / "port"),
                         "--device", "cpu"])
    for run in ("jax", "port"):
        infer = ["--model", str(tmp_path / run / "model.npz"),
                 "--input-dir", str(graph_dir), "--n-graphs", "5",
                 "--hidden-dim", "8", "--n-iters", "2"]
        want = jinfer.main(infer)
        got = tinfer.main(infer + ["--device", "cpu", "--output",
                                   str(tmp_path / f"{run}.json")])
        assert [r["file"] for r in got] == [r["file"] for r in want]
        assert [r["n_edges"] for r in got] == [r["n_edges"] for r in want]
        np.testing.assert_allclose(_scores(got), _scores(want), **SCORE_TOL)
        with open(tmp_path / f"{run}.json") as f:
            assert json.load(f) == got


def test_infer_cli_benchmark_times_the_forward(graph_dir, tmp_path):
    ttrain.main(["--input-dir", str(graph_dir), "--n-epochs", "1",
                 "--output-dir", str(tmp_path), "--device", "cpu", *COMMON])
    results, latency = tinfer.run(tinfer.parse_args(
        ["--model", str(tmp_path / "model.npz"), "--input-dir",
         str(graph_dir), "--hidden-dim", "8", "--n-iters", "2",
         "--benchmark", "--device", "cpu"]))
    assert len(results) == 1 and latency > 0


@pytest.mark.parametrize("strategy", ["dp", "partitioned"])
def test_train_cli_strategies_are_not_ported(graph_dir, strategy):
    """The parallel strategies are ported: without a launcher they run as
    a world of one, whose losses are the single strategy's, and leave no
    process group behind (the multi-rank runs against the JAX CLI are in
    tests/test_torch_parallel_ranks.py)."""
    import torch.distributed as dist

    args = ["--input-dir", str(graph_dir), "--device", "cpu",
            "--n-epochs", "2", *COMMON]
    want = ttrain.main(args)
    got = ttrain.main(args + ["--strategy", strategy])
    assert not dist.is_initialized()
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               **LOSS_TOL)
    np.testing.assert_allclose(got.valid_losses, want.valid_losses,
                               **LOSS_TOL)


def test_blocked_needs_layer_arrays(tmp_path):
    cfg = jtoy.Toy2DConfig(n_layers=4, n_tracks=2, seed=1)
    gs = jtoy.make_segment_graphs(cfg, 4)
    for i in range(4):
        jg.save_npz(jax.tree.map(lambda a: np.asarray(a)[i], gs),
                    str(tmp_path / f"g{i}.npz"))
    with pytest.raises(ValueError, match="layer"):
        ttrain.main(["--input-dir", str(tmp_path), "--aggregation",
                     "blocked", "--device", "cpu", "--batch-size", "2",
                     "--valid-frac", "0", "--test-frac", "0"])


def test_blocked_setup_serves_a_directory_loaded_twice(graph_dir):
    """The setup names graphs by position, so graphs of a second load of
    the same directory (other objects) find their offsets, and get the
    same blocks as the first load's."""
    first, layers = ttrain.load_graph_files(str(graph_dir), N_GRAPHS)
    second, _ = ttrain.load_graph_files(str(graph_dir), N_GRAPHS)
    setup = ttrain.BlockedSetup(first, layers, group=2)
    positions = [5, 1, 6, 2]
    bucket = tb.choose_bucket(first)
    batches = []
    for graphs in (first, second):
        gen = tb.batch_generator([graphs[p] for p in positions], 2, bucket,
                                 seed=4,
                                 transform=setup.transform_for(positions))
        batches.append([next(gen) for _ in range(2)])
    for a, b in zip(*batches):
        for t, u in zip(a.tensors(), b.tensors()):
            assert torch.equal(t, u)


def test_cli_needs_a_card_or_device_cpu(graph_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the GPU-less case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--input-dir", str(graph_dir), *COMMON])
    np.savez(tmp_path / "model.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinfer.main(["--model", str(tmp_path / "model.npz"),
                     "--input-dir", str(graph_dir)])
