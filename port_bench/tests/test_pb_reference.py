"""The plain reference against the program's plain paths at a small size
on the CPU, in float32: logits, the loss's gradients and Adam steps."""

import json

import pytest
import torch

from gnn_fpga_tpu_torch.train.trainer import masked_bce_with_logits
from port_bench import gen, manifest, program, reference
from port_bench.tests.small import EVENTS

CONFIGS = ("seg_h64i6", "hit_h64i7")


def _setup(name, route, n_events=1, seed=2**31 + 11):
    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())
    cfg["events"].update(EVENTS)
    cfg["compute_dtype"] = "float32"
    mix = {"layout": "packed", "route": route}
    rngs, wseed = gen.streams(seed, n_events)
    events = [gen.make_event(cfg["events"], r) for r in rngs]
    batches = program.one_signature(
        [program.layout([e], cfg["events"], mix) for e in events])
    w = reference.make_weights(cfg, wseed, "cpu")
    return cfg, mix, events, batches, w


def _real(out, cfg, ev):
    n = ev.n_node if cfg["model"] == "node_classifier" else ev.n_edge
    return out[:n]


@pytest.mark.parametrize("route", ["sparse", "pallas", "dense"])
@pytest.mark.parametrize("name", CONFIGS)
def test_logits(name, route):
    cfg, mix, events, batches, w = _setup(name, route)
    model = program.make_model(cfg, mix, w, "cpu")
    with torch.no_grad():
        got = _real(model(batches[0]), cfg, events[0])
    want = reference.logits(
        w, reference.graph_tensors(events[0].packed(), "cpu"), cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_gradients(name):
    cfg, mix, events, batches, w = _setup(name, "sparse")
    model = program.make_model(cfg, mix, w, "cpu")
    g = batches[0]
    node = cfg["target"] == "node"
    loss = masked_bce_with_logits(
        model(g), g.node_y if node else g.y,
        g.node_mask if node else g.edge_mask, cfg["pos_weight"])
    loss.backward()
    leaf = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    ref = reference.loss(leaf, reference.graph_tensors(events[0].packed(),
                                                       "cpu"), cfg)
    grads = torch.autograd.grad(ref, list(leaf.values()))
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=1e-6)
    for (k, p), want in zip(leaf.items(), grads):
        got = dict(model.named_parameters())[k].grad
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_adam_steps_under_the_cosine_rate(name):
    cfg, mix, events, batches, w = _setup(name, "sparse", n_events=3)
    cfg.update(decay_steps=4)
    trainer = program.make_trainer(program.make_model(cfg, mix, w, "cpu"),
                                   cfg)
    losses = trainer.run_steps(program.stack(batches, "cpu"))
    ref = reference.follow(
        w, [reference.graph_tensors(e.packed(), "cpu") for e in events], cfg)
    torch.testing.assert_close(torch.as_tensor(losses),
                               torch.tensor(ref["losses"]), rtol=1e-5,
                               atol=1e-6)
    state = program.train_state(trainer)
    for k, p in ref["params"].items():
        # Adam's update of an element whose gradient is near 0 is ~lr times
        # its sign, so f32 round-off there moves it by up to ~lr / 100
        torch.testing.assert_close(state["params"][k], p, rtol=1e-4,
                                   atol=cfg["learning_rate"] / 100)
        torch.testing.assert_close(state["adam"]["exp_avg"][k],
                                   ref["exp_avg"][k], rtol=1e-4, atol=1e-7)
    assert state["adam"]["step"] == ref["step"] == 3


def test_rounding_moves_the_reference():
    cfg, mix, events, batches, w = _setup("seg_h64i6", "sparse")
    g = reference.graph_tensors(events[0].packed(), "cpu")
    p32 = reference.probabilities(w, g, cfg)
    gaps = {r: float((reference.probabilities(w, g, cfg, r) - p32).abs().max())
            for r in ("bfloat16", "float8_e4m3")}
    assert 0 < gaps["bfloat16"] < gaps["float8_e4m3"]
