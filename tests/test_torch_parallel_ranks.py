"""The port's parallel paths in 2- and 4-rank gloo worlds against the JAX
package on its 8-device virtual CPU mesh.

One spawn a world size (``torch_parallel_ranks.run_world``, a module
fixture) runs every case on every rank; the tests compare:

- the sharded forward against JAX ``make_sharded_forward``, shard by
  shard at 1e-4/1e-5: halo and allgather exchanges, fused,
  plans-unfused and plain bodies, edge, node and unshared heads, with and
  without masks (the JAX side's fused and unfused bodies run their Pallas
  kernels in interpret mode, the port's run the kernels' plain versions);
- raw parameter gradients of the sharded and the data-parallel loss
  against the single-device ``jax.grad`` at 2e-3/1e-5, with L1, positive
  weights, and a dp batch whose ranks hold unequal mask counts: the
  gradients are summed once, not scaled by the number of ranks;
- five Trainer steps per strategy against the JAX Trainer's at rtol 1e-5,
  with the losses and the final weights identical on every rank;
- five stacked steps per strategy (``run_steps(stack_batches(...))``, the
  stack split along axis 1) against the JAX scan at rtol 1e-5, under a
  constant and a cosine rate with masks, equal bit for bit to the same
  steps one call a batch;
- bf16 finite; fit, checkpoints written by rank 0 and read by every rank;
- the train CLI with ``--strategy partitioned`` and ``dp`` in the 2-rank
  world against the JAX CLI at rtol 1e-4;
- no rank loads JAX or the JAX package.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

import torch_parallel_ranks as ranks
from gnn_fpga_tpu.cli import train as jtrain
from gnn_fpga_tpu.compress import pruning as jpruning
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.parallel import mesh as jmesh
from gnn_fpga_tpu.parallel import partition as jpart
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu_torch.parallel import partition as tpart

DIMS = dict(input_dim=2, hidden_dim=8, n_iters=2)
WORLDS = (2, 4)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
STEP_TOL = dict(rtol=1e-5)
CLI_TOL = dict(rtol=1e-4)
TRAIN_CFG = dict(learning_rate=3e-3, l1=1e-4, pos_weight=2.0)
MASK_THRESHOLD = 0.1

# name -> model, exchange, body, masks
FORWARD = {
    "edge-halo-fused": ("edge", "halo", "fused", False),
    "edge-halo-unfused": ("edge", "halo", "unfused", False),
    "edge-halo-plain": ("edge", "halo", "plain", False),
    "edge-allgather-plain": ("edge", "allgather", "plain", False),
    "edge-halo-fused-masks": ("edge", "halo", "fused", True),
    "edge-halo-unfused-masks": ("edge", "halo", "unfused", True),
    "edge-allgather-plain-masks": ("edge", "allgather", "plain", True),
    "node-halo-fused": ("node", "halo", "fused", False),
    "node-allgather-plain": ("node", "allgather", "plain", False),
    "unshared-halo-fused": ("unshared", "halo", "fused", False),
    "unshared-halo-plain": ("unshared", "halo", "plain", False),
}
# name -> model, exchange, body, masks, l1, pos_weight
GRAD = {
    "edge-halo-fused": ("edge", "halo", "fused", False, 0.0, 2.0),
    "edge-halo-unfused-l1": ("edge", "halo", "unfused", False, 1e-3, 1.0),
    "edge-halo-plain-l1": ("edge", "halo", "plain", False, 1e-3, 3.0),
    "edge-allgather-plain": ("edge", "allgather", "plain", False, 0.0, 2.0),
    "edge-halo-fused-masks-l1": ("edge", "halo", "fused", True, 1e-3, 2.0),
    "node-halo-fused": ("node", "halo", "fused", False, 0.0, 1.0),
    "unshared-halo-fused": ("unshared", "halo", "fused", False, 0.0, 2.0),
}
# name -> l1, pos_weight
DP_GRAD = {"dp": (0.0, 1.0), "dp-l1": (1e-3, 3.0)}

N_CLI_GRAPHS = 32
CLI_COMMON = ["--n-samples", str(N_CLI_GRAPHS), "--batch-size", "8",
              "--hidden-dim", "8", "--n-iters", "2", "--valid-frac", "0.25",
              "--test-frac", "0.25", "--learning-rate", "3e-3",
              "--pos-weight", "2", "--seed", "3", "--n-epochs", "2"]
CLI_STRATEGIES = ("partitioned", "dp")


def _jcfg(kind, body="plain", **kw):
    cls = jm.NodeClassifierConfig if kind == "node" else \
        jm.SegmentClassifierConfig
    return cls(fused_iteration=body == "fused", **DIMS, **kw)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _arrays(g) -> dict:
    return {k: None if getattr(g, k) is None else np.asarray(getattr(g, k))
            for k in ("x", "senders", "receivers", "y", "node_mask",
                      "edge_mask", "node_y")}


def _edge_graph():
    cfg = jtoy.Toy2DConfig(n_layers=8, n_tracks=6, seed=0)
    return jax.tree.map(lambda a: a[0], jtoy.make_segment_graphs(cfg, 1))


def _node_graph():
    g = _edge_graph()
    rng = np.random.default_rng(4)
    return g.replace(node_y=jnp.asarray(
        rng.integers(0, 2, g.n_node).astype(np.float32)))


def _dp_batch(seed):
    """8 Toy2D graphs, graph i with its last 3 i edges masked (ranks hold
    unequal mask counts)."""
    b = jtoy.make_segment_graphs(
        jtoy.Toy2DConfig(n_layers=5, n_tracks=3, seed=seed), 8)
    em = np.array(b.edge_mask)
    for i in range(em.shape[0]):
        em[i, em.shape[1] - 3 * i:] = 0
    return b.replace(edge_mask=jnp.asarray(em))


def _params():
    return {
        "edge": jm.init_segment_classifier(jax.random.PRNGKey(0),
                                           _jcfg("edge")),
        "unshared": jm.init_segment_classifier_unshared(
            jax.random.PRNGKey(1), _jcfg("edge")),
        "node": jm.init_node_classifier(jax.random.PRNGKey(2),
                                        _jcfg("node")),
    }


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """Toy2D window-cut sector graphs (variable edge counts) as NPZ files
    written by the JAX package."""
    d = tmp_path_factory.mktemp("graphs")
    cfg = jtoy.Toy2DConfig(n_layers=6, n_tracks=3, seed=0)
    gs = jtoy.make_window_segment_graphs(cfg, N_CLI_GRAPHS, window=0.4)
    for i in range(N_CLI_GRAPHS):
        jg.save_npz(jax.tree.map(lambda a: np.asarray(a)[i], gs),
                    str(d / f"g{i:03d}.npz"))
    return d


@pytest.fixture(scope="module")
def results(tmp_path_factory, cli_dir):
    """world -> each rank's results of every case."""
    params = _params()
    edge, node = _edge_graph(), _node_graph()
    masks = jpruning.magnitude_masks(params["edge"], MASK_THRESHOLD)
    inputs = {
        "dims": DIMS,
        "graphs": {"edge": _arrays(edge), "node": _arrays(node)},
        "params": {k: _np_tree(v) for k, v in params.items()},
        "masks": _np_tree(masks),
        "forward": {k: dict(model=m, exchange=x, body=b, masks=mk)
                    for k, (m, x, b, mk) in FORWARD.items()},
        "grad": {k: dict(model=m, exchange=x, body=b, masks=mk, l1=l1,
                         pos_weight=pw)
                 for k, (m, x, b, mk, l1, pw) in GRAD.items()},
        "dp_batch": _arrays(_dp_batch(0)),
        "dp_grad": {k: dict(l1=l1, pos_weight=pw)
                    for k, (l1, pw) in DP_GRAD.items()},
    }
    n_feature = jg.load_npz(str(cli_dir / "g000.npz")).n_feature
    cli_params = _np_tree(jm.init_segment_classifier(
        jax.random.PRNGKey(3), jm.SegmentClassifierConfig(
            input_dim=n_feature, hidden_dim=8, n_iters=2)))
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"world{world}")
        inputs["trainer"] = dict(
            cfg=TRAIN_CFG, directory=str(d), scan=_scan_inputs(),
            graphs=[_arrays(g) for g in _trainer_graphs()],
            dp_batches=[_arrays(_dp_batch(s)) for s in range(5)])
        inputs["cli"] = None if world != 2 else dict(
            params=cli_params,
            runs={s: ["--input-dir", str(cli_dir), "--strategy", s,
                      "--device", "cpu", "--output-dir", str(d / s),
                      *CLI_COMMON] for s in CLI_STRATEGIES})
        out[world] = ranks.run_world(world, inputs, d)
        out["dir", world] = d
    return out


# name -> strategy, schedule, masks: the stacked steps' cases
SCAN = {
    "partitioned-constant": ("partitioned", "constant", False),
    "partitioned-cosine-masks": ("partitioned", "cosine", True),
    "dp-constant": ("dp", "constant", False),
    "dp-cosine-masks": ("dp", "cosine", True),
}
SCHEDULES = {"constant": {},
             "cosine": dict(lr_schedule="cosine", decay_steps=3,
                            lr_min_fraction=0.1)}


def _scan_inputs() -> dict:
    return {k: dict(strategy=st, masks=mk,
                    cfg=dict(TRAIN_CFG, **SCHEDULES[sched]))
            for k, (st, sched, mk) in SCAN.items()}


def _trainer_graphs():
    return [jax.tree.map(lambda a: a[0], jtoy.make_segment_graphs(
        jtoy.Toy2DConfig(n_layers=6, n_tracks=4, seed=s), 1))
        for s in range(5)]


def _mesh(world):
    return jmesh.make_mesh((world,), (jmesh.GRAPH_AXIS,),
                           devices=jax.devices()[:world])


def _port_pg(kind, body, world):
    from torch_parallel_ranks import graph
    g = _node_graph() if kind == "node" else _edge_graph()
    return tpart.partition_graph(graph(_arrays(g)), world,
                                 plans=body != "plain")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(FORWARD))
def test_sharded_forward_matches_jax(results, world, name):
    kind, exchange, body, with_masks = FORWARD[name]
    params = _params()[kind]
    masks = (jpruning.magnitude_masks(_params()["edge"], MASK_THRESHOLD)
             if with_masks else None)
    g = _node_graph() if kind == "node" else _edge_graph()
    pg = jax.tree.map(jnp.asarray, jpart.partition_graph(
        g, world, plans=body != "plain", tile_e=32))
    fwd = jpart.make_sharded_forward(
        _mesh(world), _jcfg(kind, body), masks=masks, exchange=exchange,
        head="node" if kind == "node" else "edge",
        unshared=kind == "unshared")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fwd(params, pg))
    outs = [r["forward"][name] for r in results[world]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    got = outs[0]
    if kind == "node":
        np.testing.assert_allclose(got, want, **FWD_TOL)
        return
    port_em = _port_pg(kind, body, world).edge_mask.numpy() > 0
    jax_em = np.asarray(pg.edge_mask) > 0
    for p in range(world):
        assert port_em[p].sum() == jax_em[p].sum()
        np.testing.assert_allclose(got[p][port_em[p]], want[p][jax_em[p]],
                                   **FWD_TOL)


def _jax_grads(kind, masks, l1, pos_weight, g):
    cfg = dataclasses.replace(_jcfg(kind), aggregation="sparse")
    fn = {"edge": jm.segment_classifier_logits,
          "unshared": jm.segment_classifier_unshared_logits,
          "node": jm.node_classifier_logits}[kind]
    target, mask = (g.node_y, g.node_mask) if kind == "node" else (
        g.y, g.edge_mask)

    def loss(p):
        logits = fn(p, g, cfg, masks)
        out = jtrainer.masked_bce_with_logits(logits, target, mask,
                                              pos_weight)
        return out + l1 * jtrainer.l1_penalty(p, masks=masks)

    return jax.value_and_grad(loss)(_params()[kind])


def _as_port(kind, tree) -> dict:
    m = ranks.model(kind, _np_tree(tree), DIMS)
    return {n: p.detach().numpy() for n, p in m.named_parameters()}


def _check_grads(got_ranks, loss_want, grads_want):
    """Each rank's ``(loss, parameter change under SGD at rate 1)``
    against the single-device loss and ``jax.grad``: identical on every
    rank, and equal to the gradient (not ``P`` times it)."""
    loss0, grads0 = got_ranks[0][:2]
    for loss, grads in (r[:2] for r in got_ranks[1:]):
        assert loss == loss0
        for n in grads0:
            torch.testing.assert_close(grads[n], grads0[n], rtol=0, atol=0)
    np.testing.assert_allclose(loss0, float(loss_want), rtol=1e-5)
    for n, want in grads_want.items():
        np.testing.assert_allclose(grads0[n].numpy(), want, **GRAD_TOL,
                                   err_msg=n)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(GRAD))
def test_sharded_gradients_match_single_device_jax_grad(results, world,
                                                        name):
    kind, _, _, with_masks, l1, pw = GRAD[name]
    masks = (jpruning.magnitude_masks(_params()["edge"], MASK_THRESHOLD)
             if with_masks else None)
    g = _node_graph() if kind == "node" else _edge_graph()
    loss, grads = _jax_grads(kind, masks, l1, pw, g)
    _check_grads([r["grad"][name] for r in results[world]], loss,
                 _as_port(kind, grads))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(DP_GRAD))
def test_dp_gradients_match_single_device_jax_grad(results, world, name):
    l1, pw = DP_GRAD[name]
    counts = [r["dp_counts"] for r in results[world]]
    assert len(set(counts)) == world          # unequal mask counts
    b = _dp_batch(0)
    cfg = dataclasses.replace(_jcfg("edge"), aggregation="sparse")

    def loss(p):
        logits = jax.vmap(lambda g: jm.segment_classifier_logits(
            p, g, cfg))(b)
        out = jtrainer.masked_bce_with_logits(logits, b.y, b.edge_mask, pw)
        return out + l1 * jtrainer.l1_penalty(p)

    value, grads = jax.value_and_grad(loss)(_params()["edge"])
    got = [r["dp_grad"][name] for r in results[world]]
    _check_grads(got, value, _as_port("edge", grads))
    for _, _, eval_loss in got:                  # make_dp_eval_step
        np.testing.assert_allclose(eval_loss, float(value), rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", ["partitioned", "dp"])
def test_trainer_steps_match_jax_trainer(results, world, strategy):
    cfg = jtrainer.TrainConfig(**TRAIN_CFG)
    mcfg = _jcfg("edge")
    params = _params()["edge"]
    if strategy == "partitioned":
        t = jtrainer.Trainer(None, params, cfg, strategy="partitioned",
                             mesh=_mesh(world), model_cfg=mcfg)
        batches = [jax.tree.map(jnp.asarray,
                                jpart.partition_graph(g, world))
                   for g in _trainer_graphs()]
    else:
        fn = lambda p, g, m: jm.segment_classifier_logits(p, g, mcfg, m)
        t = jtrainer.Trainer(fn, params, cfg, strategy="dp",
                             mesh=jmesh.make_mesh())
        batches = [_dp_batch(s) for s in range(5)]
    want = []
    for b in batches:
        t.params, t.opt_state, loss = t._train_step(t.params, t.opt_state, b)
        want.append(float(loss))
    outs = [r["trainer"][strategy] for r in results[world]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
    np.testing.assert_allclose(outs[0]["losses"], want, **STEP_TOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(SCAN))
def test_stacked_steps_match_jax_scan(results, world, name):
    """``run_steps(stack_batches(...))`` under dp (the stack's batch axis
    1 split over the ranks) and partitioned (its shard axis 1) against the
    JAX ``run_steps`` scan over the same stack (``test_dp_run_steps_scan``
    and the partitioned scan, ``P(None, DATA)`` / ``P(None, GRAPH)``), with
    the cosine rate and masks: losses at rtol 1e-5, identical on every
    rank and equal bit for bit to the same steps one call a batch; pruned
    weights stay 0."""
    strategy, sched, with_masks = SCAN[name]
    cfg = jtrainer.TrainConfig(**TRAIN_CFG, **SCHEDULES[sched])
    params = _params()["edge"]
    masks = (jpruning.magnitude_masks(params, MASK_THRESHOLD)
             if with_masks else None)
    if strategy == "partitioned":
        t = jtrainer.Trainer(None, params, cfg, masks=masks,
                             strategy="partitioned", mesh=_mesh(world),
                             model_cfg=_jcfg("edge"))
        stacked = jtrainer.stack_batches(
            [jax.tree.map(jnp.asarray, jpart.partition_graph(g, world))
             for g in _trainer_graphs()])
    else:
        mcfg = _jcfg("edge")
        fn = lambda p, g, m: jm.segment_classifier_logits(p, g, mcfg, m)
        t = jtrainer.Trainer(fn, params, cfg, masks=masks, strategy="dp",
                             mesh=jmesh.make_mesh())
        stacked = jtrainer.stack_batches([_dp_batch(s) for s in range(5)])
    want = t.run_steps(stacked)
    outs = [r["trainer"]["scan"][name] for r in results[world]]
    for o in outs:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
        np.testing.assert_array_equal(o["params"], outs[0]["params"])
        np.testing.assert_array_equal(o["one_step_losses"], o["losses"])
        np.testing.assert_array_equal(o["one_step_params"], o["params"])
        if sched == "cosine":
            assert o["last_epoch"] == (5, 5.0)
        if with_masks:
            assert o["pruned"] and not any(o["pruned"])
    assert outs[0]["losses"].shape == (5,)
    np.testing.assert_allclose(outs[0]["losses"], want, **STEP_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_partitioned_runs_finite(results, world):
    for r in results[world]:
        bf16 = r["trainer"]["bf16"]
        assert np.isfinite(bf16["losses"]).all()
        assert np.isfinite(bf16["probs"]).all()
        assert bf16["probs"].dtype == np.float32


@pytest.mark.parametrize("world", WORLDS)
def test_fit_checkpoints_written_once_and_read_by_every_rank(results,
                                                             world):
    fits = [r["trainer"]["fit"] for r in results[world]]
    for f in fits:
        assert f["loaded"] and f["epoch"] == 2 and f["same_params"]
        assert f["train_losses"] == fits[0]["train_losses"]
        assert f["valid_losses"] == fits[0]["valid_losses"]
        assert f["metrics"] == fits[0]["metrics"]
    assert np.isfinite(fits[0]["train_losses"]).all()
    assert 0.0 <= fits[0]["metrics"]["accuracy"] <= 1.0
    with open(results["dir", world] / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2            # one line an epoch


@pytest.mark.parametrize("strategy", CLI_STRATEGIES)
def test_train_cli_matches_jax_cli(results, cli_dir, tmp_path, strategy):
    """Two ranks of the port's CLI against the JAX CLI on its 8 devices,
    from the same initial weights; rank 0 alone writes the outputs."""
    args = ["--input-dir", str(cli_dir), "--strategy", strategy,
            *CLI_COMMON]
    want = jtrain.main(args + ["--prefetch", "0"])
    runs = [r["cli"][strategy] for r in results[2]]
    for run in runs[1:]:
        assert run["train_losses"] == runs[0]["train_losses"]
        np.testing.assert_array_equal(run["params"], runs[0]["params"])
    np.testing.assert_allclose(runs[0]["train_losses"], want.train_losses,
                               **CLI_TOL)
    np.testing.assert_allclose(runs[0]["valid_losses"], want.valid_losses,
                               **CLI_TOL)
    out = results["dir", 2] / strategy
    assert sorted(p.name for p in out.iterdir()) == [
        "checkpoints", "losses.npz", "metrics.jsonl", "model.npz"]
    with open(out / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2            # rank 0 alone writes


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_load_neither_jax_nor_the_jax_package(results, world):
    for r in results[world]:
        assert r["modules"] == []
