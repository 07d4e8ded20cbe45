"""Every call into the program under test, ``gnn_fpga_tpu_torch``: the
layout of the generated events (packing, plans, blocks), the model, the
trainer and its stacks, the captured forward, the prefetching iterator,
and the program's own counters (kernel launches, capture timings).

The model comes from the configuration's family (``builders/<model>.py``,
:func:`port_bench.manifest.builder`).  The layout is the program's:
packed events with plans for the ``pallas`` route (``core/graph.py``:
``pack_graphs``, ``attach_plans``, plans padded to one ``PlanCapacity``
as the train CLI pads a bucket), sector batches with blocks for the
``blocked`` route (``ops/blocked.py``).  The reference never sees these.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from port_bench import gen, manifest


def load_library() -> None:
    """Build (first run in a checkout) and load the program's kernels."""
    from gnn_fpga_tpu_torch.ops.cuda import _build

    _build.load_library()


def _sector_batch(ev: gen.Event):
    from gnn_fpga_tpu_torch.core.graph import Graph

    s, n = ev.x.shape[:2]
    return Graph(
        x=torch.from_numpy(np.ascontiguousarray(ev.x)),
        senders=torch.from_numpy(np.ascontiguousarray(ev.senders)),
        receivers=torch.from_numpy(np.ascontiguousarray(ev.receivers)),
        y=torch.from_numpy(np.ascontiguousarray(ev.y)),
        node_mask=torch.ones((s, n), dtype=torch.float32),
        edge_mask=torch.ones(ev.senders.shape, dtype=torch.float32),
        node_y=None if ev.node_y is None
        else torch.from_numpy(np.ascontiguousarray(ev.node_y)))


def layout(events: list, events_cfg: dict, mix: dict):
    """A batch of events as the mix's route takes it, on the host:
    ``packed`` (one graph of every event's sectors in order, padded to
    the configuration's ``pad_nodes`` and ``pad_edges`` an event, with
    plans) or ``blocked`` (one event's batch of sectors with edges
    permuted into blocks of ``group`` layer pairs and ``block_e``
    slots)."""
    from gnn_fpga_tpu_torch.core import graph as G
    from gnn_fpga_tpu_torch.ops import blocked

    if mix["layout"] == "packed":
        graphs = [g for ev in events
                  for g in G.unbatch_graphs(_sector_batch(ev))]
        g = G.pack_graphs(graphs, n_node=len(events) * events_cfg["pad_nodes"],
                          n_edge=len(events) * events_cfg["pad_edges"])
        return G.attach_plans(g)
    if mix["layout"] == "blocked":
        if len(events) != 1:
            raise ValueError("the blocked layout takes one event a batch")
        return blocked.attach_blocks_layered(
            _sector_batch(events[0]), gen.layer_offsets(events_cfg),
            group=mix["group"], block_e=mix["block_e"])
    raise ValueError(f"unknown layout {mix['layout']!r}")


def one_signature(batches: list) -> list:
    """Packed graphs' plans padded to the least capacity that holds them
    all, so that one capture serves every batch; others as they are.
    Batches of two signatures raise."""
    from gnn_fpga_tpu_torch.core.capture import signature
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    if batches[0].plans is not None:
        cap = spmm.PlanCapacity.covering(*(b.plans for b in batches))
        batches = [b.replace(plans=spmm.pad_plans(b.plans, cap))
                   for b in batches]
    if len({signature(b) for b in batches}) != 1:
        raise ValueError("the pool's batches have more than one signature")
    return batches


def real_edges(batch) -> int:
    return int(batch.edge_mask.sum())


def kernel_shapes(batch, cfg: dict) -> dict:
    """The shapes the kernels' tables have on ``batch``, as the
    configuration's model family gives them (``builders/<model>.py``)."""
    return manifest.builder(cfg["model"]).kernel_shapes(batch, cfg)


def make_model(cfg: dict, mix: dict, weights: dict, device):
    """The configuration's model on the mix's route, built by its family
    (``builders/<model>.py``) and holding ``weights`` (by parameter name,
    the names of the family's ``leaves``)."""
    model = manifest.builder(cfg["model"]).make_model(cfg, mix, device)
    want = {name for name, _, _ in manifest.family(cfg["model"]).leaves(cfg)}
    params = dict(model.named_parameters())
    if set(params) != want or set(weights) != want:
        raise ValueError(f"the model's parameters {sorted(params)} or the "
                         f"weights {sorted(weights)} are not the family's "
                         f"leaves {sorted(want)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])
    return model


def make_trainer(model, cfg: dict):
    """The program's Trainer with the configuration's optimizer (captured
    steps on the card); the trainer's log goes to standard error."""
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(
        learning_rate=cfg["learning_rate"], optimizer=cfg["optimizer"],
        target=cfg["target"], pos_weight=cfg["pos_weight"],
        lr_schedule=cfg.get("lr_schedule", "constant"),
        decay_steps=cfg.get("decay_steps", 0),
        lr_min_fraction=cfg.get("lr_min_fraction", 0.01))
    with contextlib.redirect_stdout(sys.stderr):
        return Trainer(model, tcfg)


def stack(batches: list, device):
    from gnn_fpga_tpu_torch.train.trainer import stack_batches

    return stack_batches(batches, device)


def train_state(trainer) -> dict:
    """Copies of the trainer's weights and Adam state by parameter name."""
    named = dict(trainer.model.named_parameters())
    # an optimizer that has taken no step holds no state: zeros
    st = {k: trainer.optimizer.state.get(p, {}) for k, p in named.items()}
    moment = lambda k, m: st[k].get(m, torch.zeros_like(named[k])).clone()
    out = dict(params={k: p.detach().clone() for k, p in named.items()},
               adam=dict(step=float(next(iter(st.values())).get("step", 0)),
                         exp_avg={k: moment(k, "exp_avg") for k in named},
                         exp_avg_sq={k: moment(k, "exp_avg_sq")
                                     for k in named}))
    return out


def capture_seconds(obj):
    """Host seconds of the eager first call, the recording and the
    instantiation (``CapturedCall.timings``) of a trainer's captures or of
    one captured call, or None where nothing was captured."""
    calls = (obj._captured.values() if hasattr(obj, "_captured") else [obj])
    t = [sum(c.timings.values()) for c in calls if c.timings]
    return sum(t) if t else None


def captured_forward(model, device):
    """The infer CLI's captured scoring forward."""
    from gnn_fpga_tpu_torch.cli.infer import captured_forward as forward

    return forward(model, device)


def prefetch(source, depth: int, device):
    from gnn_fpga_tpu_torch.core.prefetch import prefetch_to_device

    return prefetch_to_device(source, size=depth, device=device)


def reset_launch_counts() -> None:
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    spmm.reset_launch_counts()


def launch_counts() -> dict:
    from gnn_fpga_tpu_torch.ops.cuda import spmm

    return spmm.launch_counts()
