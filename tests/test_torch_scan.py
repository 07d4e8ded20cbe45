"""The scanned epoch against the JAX package, on the CPU.

``stack_batches`` (``train/trainer.py``) on the one stacking helper
(``core/graph.py::stack_fields``), ``Trainer.run_steps`` on a stack (one
call for ``K`` steps, the body ``core/capture.py::scan``, which on the CPU
runs eagerly on the capture's static buffers), ``fit_stacked`` and the
step count of the cosine rate on the device, held against the JAX
``stack_batches``, ``run_steps`` (``lax.scan`` inside ``jit``) and
``fit_stacked`` from the same initial weights (carried by
``load_jax_params``): losses at rtol 1e-5, parameters at rtol 1e-5, atol
1e-6, as ``tests/test_run_steps.py`` holds the JAX scan to its per-step
path.  The JAX side's pallas route runs its kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.compress import pruning as jpruning
from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu_torch.core import capture
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.parallel import partition as tpart
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import serialization as tser

LOSS_TOL = dict(rtol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
DIMS = dict(input_dim=2, hidden_dim=8, n_iters=2)
N_STEPS, N_EVENTS = 4, 8
MASK_THRESHOLD = 0.1
TRAIN = dict(learning_rate=5e-3, pos_weight=2.0, l1=1e-4)
SCHEDULES = {"constant": {},
             "cosine": dict(lr_schedule="cosine", decay_steps=3,
                            lr_min_fraction=0.1)}


def _events(seed):
    """``N_STEPS`` JAX batches of ``N_EVENTS`` Toy2D segment graphs
    (``n_layers=6``, ``n_tracks=3``), as ``tests/test_run_steps.py``."""
    g = jtoy.make_segment_graphs(
        jtoy.Toy2DConfig(n_layers=6, n_tracks=3, seed=seed),
        N_EVENTS * N_STEPS)
    return [jax.tree.map(lambda a: a[i * N_EVENTS:(i + 1) * N_EVENTS], g)
            for i in range(N_STEPS)]


def _port(g) -> tg.Graph:
    """A JAX Graph's arrays as a port Graph (no plans)."""
    return tg.Graph(**{k: None if getattr(g, k) is None
                       else torch.from_numpy(np.array(getattr(g, k)))
                       for k in ("x", "senders", "receivers", "y",
                                 "node_mask", "edge_mask", "node_y")})


def _batches(route, seed=0):
    """``(port batches, JAX batches)``: batched ``[8, N, F]`` graphs on the
    sparse route; on the pallas route each batch packed into one graph
    with a masked pad tail, the port's plans padded to a capacity above
    every batch's (pad entries), the JAX plans built by its own
    ``attach_plans``."""
    jb = _events(seed)
    if route == "sparse":
        return [_port(b) for b in jb], jb
    packed_j = [jg.pack_graphs(jg.unbatch_graphs(b), n_node=b.x.shape[1]
                               * N_EVENTS + 4,
                               n_edge=b.senders.shape[1] * N_EVENTS + 24)
                for b in jb]
    packed_t = [tg.attach_plans(_port(g)) for g in packed_j]
    cap = tsp.PlanCapacity.covering(
        *(g.plans for g in packed_t)).with_headroom(1.5)
    packed_t = [g.replace(plans=tsp.pad_plans(g.plans, cap))
                for g in packed_t]
    plans_j = jg.attach_plans(jax.tree.map(jnp.asarray, packed_j[0]),
                              tile_e=32).plans
    return packed_t, [jax.tree.map(jnp.asarray, g).replace(plans=plans_j)
                      for g in packed_j]


def _models(route, seed=1):
    cfg_j = jm.SegmentClassifierConfig(aggregation=route, **DIMS)
    params = jm.init_segment_classifier(jax.random.PRNGKey(seed), cfg_j)
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(aggregation=route, **DIMS),
        torch.Generator().manual_seed(seed), device="cpu")
    tser.load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg_j, params, model


def _masks(params, with_masks):
    if not with_masks:
        return None, None
    masks_j = jpruning.magnitude_masks(params, MASK_THRESHOLD)
    masks_t = tser.load_jax_masks(jax.tree.map(np.asarray, masks_j),
                                  DIMS["input_dim"], DIMS["hidden_dim"],
                                  "cpu")
    return masks_j, masks_t


def _jax_trainer(cfg_j, params, tcfg, masks_j=None, **kw):
    return jtrainer.Trainer(
        lambda p, g, m: jm.segment_classifier_logits(p, g, cfg_j, m),
        params, jtrainer.TrainConfig(**tcfg), masks=masks_j, **kw)


def _assert_params_match(model, params_j):
    got = tser.to_jax_params(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params_j)):
        np.testing.assert_allclose(a, np.asarray(b), **PARAM_TOL)


def _fields(v, path="batch"):
    """``(path, value)`` of every tensor and host field of ``v``."""
    if isinstance(v, torch.Tensor) or not isinstance(v, tg.TensorFields):
        yield path, v
        return
    for f in dataclasses.fields(v):
        yield from _fields(getattr(v, f.name), f"{path}.{f.name}")


def _assert_stacked(stacked, batches):
    """``stacked`` equals numpy stacking of ``batches`` field by field;
    host fields are the first batch's."""
    per = [dict(_fields(b)) for b in batches]
    for path, v in _fields(stacked):
        vals = [p[path] for p in per]
        if isinstance(v, torch.Tensor):
            assert v.dtype == vals[0].dtype, path
            np.testing.assert_array_equal(
                v.numpy(), np.stack([t.numpy() for t in vals]), err_msg=path)
        else:
            assert all(x == v for x in vals), path


# ---------------------------------------------------------------------------
# stack_batches
# ---------------------------------------------------------------------------

def test_stack_batches_equals_numpy_stacking():
    """Packed graphs with padded plans, batched graphs and partitioned
    graphs with plans stack field by field as numpy stacks them; the
    stack is on the batches' device, or on ``device``."""
    packed, _ = _batches("pallas")
    batched, _ = _batches("sparse")
    parts = [tpart.partition_graph(tg.unbatch_graphs(b)[0], 2, plans=True)
             for b in batched]
    for batches in (packed, batched, parts):
        stacked = ttrainer.stack_batches(batches)
        assert type(stacked) is type(batches[0])
        assert stacked.x.shape == (N_STEPS,) + tuple(batches[0].x.shape)
        _assert_stacked(stacked, batches)
        assert stacked.x.device == torch.device("cpu")
        assert ttrainer.stack_batches(batches, device="cpu").x.device.type \
            == "cpu"
    for k in range(N_STEPS):
        one = tg.index_fields(ttrainer.stack_batches(packed), k)
        assert capture.signature(one) == capture.signature(packed[k])
        for a, b in zip(one.tensors(), packed[k].tensors()):
            assert torch.equal(a, b)


def test_stack_batches_refuses_batches_that_differ():
    """Unpadded plans of other topologies, a field present in some
    batches only, other shapes: each raises ValueError naming the field,
    as jax.tree.map refuses trees whose static parts differ."""
    packed, _ = _batches("pallas")
    # the same node and edge counts, another topology: a hub of 40 edges
    # gives the plans more items than the other graph's
    s = packed[1].senders.clone()
    s[:40] = 0
    other = [tg.attach_plans(g.replace(plans=None))
             for g in (packed[0], packed[1].replace(senders=s))]
    with pytest.raises(ValueError, match="plans.*PlanCapacity"):
        ttrainer.stack_batches(other)
    with pytest.raises(ValueError, match="node_y"):
        ttrainer.stack_batches([packed[0], packed[1].replace(
            node_y=torch.zeros(packed[1].n_node))])
    batched, _ = _batches("sparse")
    with pytest.raises(ValueError, match=r"Graph\.x"):
        ttrainer.stack_batches([batched[0], tg.Graph(**{
            f.name: getattr(batched[1], f.name)[:4]
            if getattr(batched[1], f.name) is not None else None
            for f in dataclasses.fields(tg.Graph)})])
    with pytest.raises(ValueError, match="at least one"):
        ttrainer.stack_batches([])
    # a stack of one is a view of the batch
    one = ttrainer.stack_batches(packed[:1])
    assert one.x.data_ptr() == packed[0].x.data_ptr()


def test_local_shard_takes_the_shard_axis_it_is_told():
    """A rank's shard of a stack of partitioned graphs is axis 1's (the
    stack of each graph's shard); of one graph, axis 0's; a graph whose
    shape does not hold the shards on the axis named raises."""
    batched, _ = _batches("sparse")
    pgs = [tpart.partition_graph(tg.unbatch_graphs(b)[0], 2, plans=True)
           for b in batched]
    stack = ttrainer.stack_batches(pgs)
    for rank in range(2):
        got = tpart.local_shard(stack, rank, "cpu", axis=1)
        want = ttrainer.stack_batches([pg.shard(rank) for pg in pgs])
        assert capture.signature(got) == capture.signature(want)
        for a, b in zip(got.tensors(), want.tensors()):
            assert torch.equal(a, b)
        one = tpart.local_shard(pgs[0], rank, "cpu")
        assert capture.signature(one) == capture.signature(
            pgs[0].shard(rank))
    with pytest.raises(ValueError, match="axis 0"):
        tpart.local_shard(stack, 0, "cpu")
    with pytest.raises(ValueError, match="axis 1"):
        tpart.local_shard(pgs[0], 0, "cpu", axis=1)


# ---------------------------------------------------------------------------
# run_steps on a stack against the JAX scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_masks", [False, True], ids=["dense",
                                                          "masks"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("route", ["sparse", "pallas"])
def test_run_steps_on_a_stack_matches_jax_scan(route, schedule, with_masks):
    """``run_steps(stack_batches(batches))`` against the JAX
    ``run_steps(stack_batches(batches))`` from the same weights: the four
    losses and the trained weights; pruned weights stay exactly 0."""
    tbatches, jbatches = _batches(route)
    cfg_j, params, model = _models(route)
    masks_j, masks_t = _masks(params, with_masks)
    tcfg = dict(TRAIN, **SCHEDULES[schedule])
    tr_j = _jax_trainer(cfg_j, params, tcfg, masks_j)
    with pltpu.force_tpu_interpret_mode():
        want = tr_j.run_steps(jtrainer.stack_batches(jbatches))
    tr_t = ttrainer.Trainer(model, ttrainer.TrainConfig(**tcfg),
                            masks=masks_t)
    got = tr_t.run_steps(ttrainer.stack_batches(tbatches))
    assert got.shape == (N_STEPS,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_params_match(model, tr_j.params)
    if tr_t.scheduler is not None:
        assert tr_t.scheduler.last_epoch == N_STEPS
    if with_masks:
        for mod, layer in masks_t.items():
            for name, m in layer.items():
                if m is not None:
                    w = getattr(getattr(model, mod), name).weight
                    assert (w[m == 0] == 0).all(), (mod, name)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_k_step_call_equals_one_step_calls_bit_for_bit(schedule):
    """The K-step call (one stack) and ``K`` one-step calls (``fit``'s
    path, one batch a call) run one step body and one rate mechanism: the
    same losses and weights bit for bit, and the rate's step count on the
    device where the host's is."""
    tbatches, _ = _batches("pallas", seed=2)
    _, _, base = _models("pallas", seed=4)
    cfg = ttrainer.TrainConfig(**TRAIN, **SCHEDULES[schedule])
    runs = {}
    for kind in ("stack", "steps"):
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), "cpu")
        model.load_state_dict(base.state_dict())
        tr = ttrainer.Trainer(model, cfg)
        if kind == "stack":
            losses = tr.run_steps(ttrainer.stack_batches(tbatches))
        else:
            losses = np.array([float(tr._train_step(b)) for b in tbatches],
                              np.float32)
        runs[kind] = (losses, [p.detach().clone() for p in
                               model.parameters()], tr)
    np.testing.assert_array_equal(runs["stack"][0], runs["steps"][0])
    for a, b in zip(runs["stack"][1], runs["steps"][1]):
        assert torch.equal(a, b)
    for _, _, tr in runs.values():
        if tr.scheduler is not None:
            assert tr.scheduler.last_epoch == N_STEPS
            assert float(tr.scheduler.count) == N_STEPS
            rate = tr.optimizer.param_groups[0]["lr"]
            np.testing.assert_allclose(float(rate), tr.scheduler.rate(),
                                       rtol=1e-6)


def test_a_sequence_runs_as_stacks_of_one_signature():
    """``run_steps`` of a sequence stacks it: one call (one capture) for
    a run of one signature, with the stack's losses bit for bit; a
    sequence of two signatures runs one stack a run, in order."""
    tbatches, _ = _batches("pallas", seed=5)
    _, _, base = _models("pallas", seed=6)
    out = {}
    for kind in ("list", "stack"):
        model = tm.SegmentClassifier(base.cfg, torch.Generator(), "cpu")
        model.load_state_dict(base.state_dict())
        tr = ttrainer.Trainer(model, ttrainer.TrainConfig(**TRAIN))
        batches = (tbatches if kind == "list"
                   else ttrainer.stack_batches(tbatches))
        out[kind] = tr.run_steps(batches)
        assert len(tr._captured) == 1
        (_, sig), = tr._captured
        assert sig == capture.signature(ttrainer.stack_batches(tbatches))
    np.testing.assert_array_equal(out["list"], out["stack"])
    small, _ = _batches("sparse", seed=5)
    tr = ttrainer.Trainer(_models("sparse", seed=6)[2],
                          ttrainer.TrainConfig(**TRAIN))
    pad = lambda t: torch.cat([t, torch.zeros_like(t[:, :1])], 1)
    losses = tr.run_steps(small[:2] + [small[2].replace(
        x=pad(small[2].x), node_mask=pad(small[2].node_mask))] + small[3:])
    assert losses.shape == (N_STEPS,) and np.isfinite(losses).all()
    assert sorted(sig[1][1][0][0] for _, sig in tr._captured) == [1, 1, 2]
    with pytest.raises(ValueError, match="stack of batches"):
        tr.run_steps(tbatches[0])


# ---------------------------------------------------------------------------
# fit_stacked and the step count across a checkpoint
# ---------------------------------------------------------------------------

def test_fit_stacked_trains_and_records_as_jax(tmp_path):
    """``fit_stacked`` over a stacked epoch, as ``tests/test_run_steps.py``
    holds the JAX one: 8 epochs, validation, checkpoints and metrics, a
    falling loss; the epoch losses are the JAX ``fit_stacked``'s."""
    tbatches, jbatches = _batches("sparse", seed=3)
    cfg_j, params, model = _models("sparse", seed=7)
    tcfg = dict(learning_rate=5e-3)
    tr_j = _jax_trainer(cfg_j, params, tcfg)
    tr_j.fit_stacked(jtrainer.stack_batches(jbatches), n_epochs=8,
                     valid_batch=jbatches[0])
    tr = ttrainer.Trainer(model, ttrainer.TrainConfig(**tcfg),
                          checkpoint_dir=str(tmp_path / "ckpt"),
                          metrics_path=str(tmp_path / "metrics.jsonl"))
    tr.fit_stacked(ttrainer.stack_batches(tbatches), n_epochs=8,
                   valid_batch=tbatches[0])
    assert len(tr.train_losses) == 8 and len(tr.valid_losses) == 8
    assert tr.train_losses[-1] < tr.train_losses[0]
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 8
    assert tr.ckpt.exists() and tr.ckpt.exists(best=True)
    np.testing.assert_allclose(tr.train_losses, tr_j.train_losses,
                               **LOSS_TOL)
    np.testing.assert_allclose(tr.valid_losses, tr_j.valid_losses,
                               **LOSS_TOL)


def test_state_after_k_steps_resumes_the_cosine_count(tmp_path):
    """After a K-step call the state dict holds ``K`` steps; a trainer
    resumed from the checkpoint sets the device step count and rate
    there, and its next stack runs as the first trainer's, bit for bit,
    and as the JAX scan's steps 5-8 over both stacks."""
    first, jfirst = _batches("pallas", seed=8)
    second, jsecond = _batches("pallas", seed=9)
    cfg_j, params, model = _models("pallas", seed=10)
    tcfg = dict(TRAIN, lr_schedule="cosine", decay_steps=6,
                lr_min_fraction=0.1)
    cfg = ttrainer.TrainConfig(**tcfg)
    tr = ttrainer.Trainer(model, cfg, checkpoint_dir=str(tmp_path))
    tr.run_steps(ttrainer.stack_batches(first))
    assert tr._state()["scheduler"] == {"last_epoch": N_STEPS}
    tr.save_checkpoint(False)
    again = ttrainer.Trainer(_models("pallas", seed=11)[2], cfg,
                             checkpoint_dir=str(tmp_path))
    assert again.load_checkpoint()
    assert again.scheduler.last_epoch == N_STEPS
    assert float(again.scheduler.count) == N_STEPS
    assert torch.equal(again.optimizer.param_groups[0]["lr"],
                       tr.optimizer.param_groups[0]["lr"])
    stack = ttrainer.stack_batches(second)
    got = again.run_steps(stack)
    np.testing.assert_array_equal(got, tr.run_steps(stack))
    for a, b in zip(again.model.parameters(), tr.model.parameters()):
        assert torch.equal(a, b)
    assert again.scheduler.last_epoch == 2 * N_STEPS

    tr_j = _jax_trainer(cfg_j, params, tcfg)
    with pltpu.force_tpu_interpret_mode():
        tr_j.run_steps(jtrainer.stack_batches(jfirst))
        want = tr_j.run_steps(jtrainer.stack_batches(jsecond))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    _assert_params_match(again.model, tr_j.params)
