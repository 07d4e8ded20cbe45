"""The captured step's plumbing (``core/capture.py``, ``train/trainer.py``,
``cli/infer.py``), on the CPU.

On the CPU a captured call copies each batch into its static buffers and
runs its body there eagerly, so everything but the CUDA graph itself runs
here: the cache keyed by batch signature, the copies, the signature
check, the device-tensor cosine rate, the losses read back once an epoch,
and the cache dropped on a checkpoint or weight load.  The graphs
themselves are captured and replayed in ``tests/test_torch_cuda.py``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from gnn_fpga_tpu.core import graph as jg
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu_torch.cli import infer as tinfer
from gnn_fpga_tpu_torch.core import capture
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.models import mpnn as tm
from gnn_fpga_tpu_torch.ops.cuda import spmm as tsp
from gnn_fpga_tpu_torch.train import trainer as ttrainer
from gnn_fpga_tpu_torch.utils import serialization as tser

F, HID, ITERS = 3, 8, 2


def _packed(seed, v, e, capacity=None, n_pad=16):
    """A packed graph of ``v`` nodes and ``e`` edges, ``n_pad`` of them
    masked on the pad node, with plans (padded to ``capacity`` when
    given)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(v, F)).astype(np.float32)
    x[-1] = 0
    s = rng.integers(0, v - 1, e).astype(np.int32)
    r = rng.integers(0, v - 1, e).astype(np.int32)
    s[-n_pad:] = r[-n_pad:] = v - 1
    em = np.ones(e, np.float32)
    em[-n_pad:] = 0
    y = (rng.random(e) < 0.3).astype(np.float32)
    g = tg.from_coo(x, s, r, y).replace(edge_mask=torch.from_numpy(em))
    return tg.attach_plans(g, capacity=capacity)


def _two_signatures(n):
    """``n`` batches alternating between two static signatures: graphs of
    60 nodes and 128 edges, then of 48 and 96, each kind's plans padded to
    the capacity that holds all of its graphs."""
    kinds = [(60, 128), (48, 96)]
    raw = [_packed(i, *kinds[i % 2]) for i in range(n)]
    caps = [tsp.PlanCapacity.covering(*(g.plans for g in raw[k::2]))
            for k in (0, 1)]
    return [g.replace(plans=tsp.pad_plans(g.plans, caps[i % 2]))
            for i, g in enumerate(raw)]


def _model(seed=0, **kw):
    cfg = tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                     n_iters=ITERS, aggregation="pallas",
                                     **kw)
    return tm.init_segment_classifier(cfg, torch.Generator().manual_seed(seed),
                                      device="cpu")


def _copy(model):
    m = tm.SegmentClassifier(model.cfg, torch.Generator(), device="cpu")
    m.load_state_dict(model.state_dict())
    return m


def test_signature_tells_batches_apart():
    a, b = _packed(0, 60, 128), _packed(1, 60, 128, n_pad=40)
    sig = capture.signature
    assert sig(a) != sig(b)            # unpadded plans: other item counts
    cap = tsp.PlanCapacity.covering(a.plans, b.plans)
    pa, pb = (g.replace(plans=tsp.pad_plans(g.plans, cap)) for g in (a, b))
    assert sig(pa) == sig(pb)
    # the host ints count: plans padded to one more recv item differ
    more = dataclasses.replace(cap, recv_items=cap.recv_items + 1)
    assert sig(pa) != sig(pa.replace(plans=tsp.pad_plans(a.plans, more)))
    assert sig(pa) != sig(pa.replace(x=pa.x.double()))
    assert sig(pa) != sig(pa.replace(node_y=torch.zeros(60)))
    assert sig(pa) == sig(pa.to("cpu"))


def test_captured_call_copies_into_its_buffers_and_checks_signatures():
    calls = []

    def fn(g):
        calls.append(g)
        return (g.x * 2).sum(-1)

    batches = _two_signatures(4)
    call = capture.CapturedCall(fn, "cpu")
    out = call(batches[0])
    torch.testing.assert_close(out, (batches[0].x * 2).sum(-1))
    assert calls[-1] is call.inputs and call.inputs.x is not batches[0].x
    call(batches[2])
    assert calls[-1] is call.inputs
    for a, b in zip(call.inputs.tensors(), batches[2].tensors()):
        assert torch.equal(a, b)
    assert not call.captured
    with pytest.raises(ValueError, match="another static signature"):
        call(batches[1])


def test_static_buffer_steps_match_eager_steps_bit_for_bit():
    """Five steps over two alternating signatures: the trainer's captured
    path (static buffers, the body run eagerly on the CPU, one call a
    signature) gives the eager steps' losses and weights bit for bit."""
    batches = _two_signatures(5)
    base = _model(1)
    cfg = ttrainer.TrainConfig(learning_rate=5e-3, pos_weight=3.0, l1=1e-4,
                               lr_schedule="cosine", decay_steps=4)
    captured = ttrainer.Trainer(_copy(base), cfg)
    eager = ttrainer.Trainer(_copy(base), cfg, capture=False)
    got = captured.run_steps(batches)
    want = eager.run_steps(batches)
    np.testing.assert_array_equal(got, want)
    assert len(captured._captured) == 2 and not eager._captured
    for a, b in zip(captured.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    # eval loss and predict take their own calls, on the same signatures
    assert captured._eval_loss(batches[1]) == eager._eval_loss(batches[1])
    p_got = captured.predict(iter(batches[:2]), 2)[0]
    p_want = eager.predict(iter(batches[:2]), 2)[0]
    np.testing.assert_array_equal(p_got, p_want)
    assert {k for k, _ in captured._captured} == {"train", "eval",
                                                  "predict"}
    assert len(captured._captured) == 5


def test_device_rate_follows_cosine_decay_at_every_step():
    cfg = ttrainer.TrainConfig(learning_rate=2e-2, lr_schedule="cosine",
                               decay_steps=7, lr_min_fraction=0.1)
    p = torch.nn.Parameter(torch.zeros(3))
    q = torch.nn.Parameter(torch.zeros(3))
    opt, sched = ttrainer.make_optimizer(cfg, [p], device_rate=True)
    ref_opt, ref_sched = ttrainer.make_optimizer(cfg, [q])
    rate = opt.param_groups[0]["lr"]
    assert isinstance(rate, torch.Tensor) and rate.dtype == torch.float32
    assert not isinstance(ref_opt.param_groups[0]["lr"], torch.Tensor)
    g = torch.tensor([0.5, -1.0, 2.0])
    for t in range(12):                       # past decay_steps: clamped
        assert opt.param_groups[0]["lr"] is rate      # filled in place
        want = cfg.learning_rate * ttrainer.cosine_decay(t, 7, 0.1)
        np.testing.assert_allclose(rate.item(), want, rtol=1e-6)
        np.testing.assert_allclose(ref_opt.param_groups[0]["lr"], want,
                                   rtol=1e-12)
        p.grad, q.grad = g.clone(), g.clone()
        opt.step()
        ref_opt.step()
        sched.step()
        ref_sched.step()
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6,
                                   atol=1e-9)
    assert sched.last_epoch == 12
    # resuming: the state dict sets the step and the rate
    opt2, sched2 = ttrainer.make_optimizer(cfg, [p], device_rate=True)
    sched2.load_state_dict(sched.state_dict())
    np.testing.assert_allclose(opt2.param_groups[0]["lr"].item(),
                               rate.item(), rtol=0)
    # a LambdaLR's state dict (earlier checkpoints) resumes too
    sched2.load_state_dict({"last_epoch": 3, "base_lrs": [2e-2]})
    np.testing.assert_allclose(opt2.param_groups[0]["lr"].item(),
                               2e-2 * ttrainer.cosine_decay(3, 7, 0.1),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="capture=False"):
        ttrainer.make_optimizer(dataclasses.replace(cfg, optimizer="sgd"),
                                [p], device_rate=True)


def _fit_losses(verbose, batches, n_epochs=2):
    tr = ttrainer.Trainer(_model(2), ttrainer.TrainConfig(
        learning_rate=3e-3, pos_weight=8.0))
    gen = iter(batches * n_epochs)
    tr.fit(gen, n_batches=len(batches), n_epochs=n_epochs, verbose=verbose)
    return tr


def test_losses_read_back_once_an_epoch_match_each_step_and_jax():
    """``fit`` reads an epoch's losses back once (verbose 0) or after each
    step (verbose 1): the same ``train_losses`` bit for bit, and the JAX
    Trainer's at the rtol of tests/test_torch_train.py."""
    rng = np.random.default_rng(4)
    v, e = 60, 128
    s = rng.integers(0, v - 1, e).astype(np.int32)
    r = rng.integers(0, v - 1, e).astype(np.int32)
    s[-16:] = r[-16:] = v - 1
    em = np.ones(e, np.float32)
    em[-16:] = 0
    tb, jb = [], []
    for _ in range(3):
        x = rng.normal(size=(v, F)).astype(np.float32)
        x[-1] = 0
        y = (rng.random(e) < 0.3).astype(np.float32)
        tb.append(tg.attach_plans(tg.from_coo(x, s, r, y).replace(
            edge_mask=torch.from_numpy(em))))
        jb.append(jg.from_coo(x, s, r, y).replace(edge_mask=em))
    once = _fit_losses(0, tb)
    each = _fit_losses(1, tb)
    assert once.train_losses == each.train_losses
    assert len(once.train_losses) == 2

    cfg_j = jm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                       n_iters=ITERS, aggregation="pallas")
    params = jax.tree.map(jax.numpy.asarray,
                          tser.to_jax_params(_model(2)))
    plans_j = jg.attach_plans(jb[0], tile_e=32).plans
    tr_j = jtrainer.Trainer(
        lambda p, g, m: jm.segment_classifier_logits(p, g, cfg_j, m),
        params, jtrainer.TrainConfig(learning_rate=3e-3, pos_weight=8.0))
    with pltpu.force_tpu_interpret_mode():
        tr_j.fit(iter([g.replace(plans=plans_j) for g in jb] * 2),
                 n_batches=3, n_epochs=2)
    np.testing.assert_allclose(once.train_losses, tr_j.train_losses,
                               rtol=1e-5)


def test_checkpoint_and_weight_loads_drop_the_captures(tmp_path):
    batches = _two_signatures(4)
    tr = ttrainer.Trainer(_model(3), ttrainer.TrainConfig(
        lr_schedule="cosine", decay_steps=10), checkpoint_dir=str(tmp_path))
    tr.fit(iter(batches), n_batches=4, n_epochs=1)
    assert len(tr._captured) == 2
    tr.load_weights(_model(4).state_dict())
    assert not tr._captured
    tr.run_steps(batches[:2])
    assert len(tr._captured) == 2
    assert tr.load_checkpoint()
    assert not tr._captured
    assert tr.scheduler.last_epoch == 4
    # after the load the steps go on from the restored state
    again = ttrainer.Trainer(_model(5), ttrainer.TrainConfig(
        lr_schedule="cosine", decay_steps=10), checkpoint_dir=str(tmp_path),
        capture=False)
    assert again.load_checkpoint()
    np.testing.assert_array_equal(tr.run_steps(batches),
                                  again.run_steps(batches))


def test_infer_forward_captured_matches_eager():
    model = tm.init_segment_classifier(
        tm.SegmentClassifierConfig(input_dim=F, hidden_dim=HID,
                                   n_iters=ITERS),
        torch.Generator().manual_seed(6), device="cpu")
    graphs = [tg.pad_graph(_packed(i, 40, 96).replace(plans=None), 48, 128)
              for i in range(3)]
    forward = tinfer.captured_forward(model, "cpu")
    for g in graphs:
        with torch.no_grad():
            want = tm.segment_classifier(model, g)
        assert torch.equal(forward(g), want)
    assert tinfer.benchmark(forward, graphs[0], n_rep=3) > 0
