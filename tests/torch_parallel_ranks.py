"""The rank bodies of the port's multi-rank CPU tests.

This module imports torch and the port only, never JAX or the JAX
package, so that the ranks it spawns never load them.  :func:`run_world`
writes the inputs (numpy arrays and the JAX package's parameter trees as
numpy) to a directory, spawns ``world`` processes that join a gloo group
through a ``file://`` rendezvous there, and returns what each rank wrote:
every case of the inputs run once by every rank (the sharded forward, raw
gradients, Trainer steps, the train CLI, the modules the rank loaded).
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 300


def run_world(world: int, inputs: dict, directory) -> list:
    """Run every case of ``inputs`` on ``world`` spawned gloo ranks; the
    results of each rank, in rank order."""
    directory = str(directory)
    torch.save(inputs, os.path.join(directory, "inputs.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, directory))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = os.path.join(directory, f"error_{r}.txt")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errors.append(f"rank {r} exited with {p.exitcode}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return [torch.load(os.path.join(directory, f"out_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, directory: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{directory}/rendezvous", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"),
                            weights_only=False)
        out = run_cases(inputs, world)
        out["modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "gnn_fpga_tpu"))
        torch.save(out, os.path.join(directory, f"out_{rank}.pt"))
    except BaseException:
        with open(os.path.join(directory, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Models and graphs from the inputs
# ---------------------------------------------------------------------------

def graph(arrays: dict):
    from gnn_fpga_tpu_torch.core.graph import Graph

    return Graph(**{k: None if v is None else torch.from_numpy(np.array(v))
                    for k, v in arrays.items()})


def model(kind: str, params, dims: dict, body: str = "plain",
          bf16: bool = False):
    """The port's ``kind`` model ("edge", "unshared", "node") holding the
    JAX parameter tree ``params``; ``body`` "fused" sets
    ``fused_iteration``."""
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.utils.serialization import load_jax_params

    kw = dict(input_dim=dims["input_dim"], hidden_dim=dims["hidden_dim"],
              n_iters=dims["n_iters"], fused_iteration=body == "fused",
              compute_dtype=torch.bfloat16 if bf16 else None)
    gen = torch.Generator().manual_seed(0)
    if kind == "node":
        m = mpnn.NodeClassifier(mpnn.NodeClassifierConfig(**kw), gen, "cpu")
    elif kind == "unshared":
        m = mpnn.SegmentClassifierUnshared(mpnn.SegmentClassifierConfig(**kw),
                                           gen, "cpu")
    else:
        m = mpnn.SegmentClassifier(mpnn.SegmentClassifierConfig(**kw), gen,
                                   "cpu")
    load_jax_params(m, params)
    return m


def _masks(inputs, case):
    from gnn_fpga_tpu_torch.utils.serialization import load_jax_masks

    if not case.get("masks"):
        return None
    d = inputs["dims"]
    return load_jax_masks(inputs["masks"], d["input_dim"], d["hidden_dim"],
                          "cpu")


def _sgd_step_grads(m, step, batch) -> tuple:
    """``(loss, gradients)`` of one ``step(batch)`` of ``m`` under SGD at
    rate 1: each parameter moves by exactly its summed gradient."""
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    loss = float(step(batch))
    return loss, {n: before[n] - p.detach()
                  for n, p in m.named_parameters()}


def _params(m) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in m.parameters()])


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

def run_cases(inputs: dict, world: int) -> dict:
    from gnn_fpga_tpu_torch.compress.pruning import apply_masks_to_params
    from gnn_fpga_tpu_torch.parallel import data_parallel as dp
    from gnn_fpga_tpu_torch.parallel import mesh as mesh_lib
    from gnn_fpga_tpu_torch.parallel import partition as part
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig

    gmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.GRAPH_AXIS,),
                               device="cpu")
    dmesh = mesh_lib.make_mesh(axis_names=(mesh_lib.DATA_AXIS,),
                               device="cpu")
    dims = inputs["dims"]
    out = {"forward": {}, "grad": {}, "dp_grad": {}}
    graphs = {k: graph(v) for k, v in inputs["graphs"].items()}

    def pg_for(case):
        g = graphs["node" if case["model"] == "node" else "edge"]
        return part.partition_graph(g, world,
                                    plans=case["body"] != "plain")

    for name, case in inputs["forward"].items():
        m = model(case["model"], inputs["params"][case["model"]], dims,
                  case["body"])
        fwd = part.make_sharded_forward(
            gmesh, m, _masks(inputs, case), case["exchange"],
            "node" if case["model"] == "node" else "edge")
        with torch.no_grad():
            out["forward"][name] = fwd(pg_for(case)).numpy()

    for name, case in inputs["grad"].items():
        m = model(case["model"], inputs["params"][case["model"]], dims,
                  case["body"])
        masks = _masks(inputs, case)
        apply_masks_to_params(m, masks)      # pruned weights start at 0
        step = part.make_sharded_train_step(
            torch.optim.SGD(m.parameters(), lr=1.0), gmesh, m, case["l1"],
            masks, case["exchange"],
            "node" if case["model"] == "node" else "edge",
            case["pos_weight"])
        out["grad"][name] = _sgd_step_grads(m, step, pg_for(case))

    batch = graph(inputs["dp_batch"])
    for name, case in inputs["dp_grad"].items():
        m = model("edge", inputs["params"]["edge"], dims)
        cfg = TrainConfig(l1=case["l1"], pos_weight=case["pos_weight"])
        evaluate = dp.make_dp_eval_step(m, dmesh, cfg)
        eval_loss = float(evaluate(batch))
        step = dp.make_dp_train_step(
            m, torch.optim.SGD(m.parameters(), lr=1.0), dmesh, cfg)
        out["dp_grad"][name] = _sgd_step_grads(m, step, batch) + (
            eval_loss,)
    out["dp_counts"] = float(mesh_lib.shard_batch(
        batch, dmesh, mesh_lib.DATA_AXIS).edge_mask.sum())

    out["trainer"] = _trainer_cases(inputs, graphs, gmesh, dmesh, world)
    if inputs.get("cli"):
        out["cli"] = _cli_cases(inputs["cli"])
    return out


def _trainer_cases(inputs, graphs, gmesh, dmesh, world) -> dict:
    from gnn_fpga_tpu_torch.parallel import partition as part
    from gnn_fpga_tpu_torch.train.trainer import TrainConfig, Trainer

    tc = inputs["trainer"]
    dims = inputs["dims"]
    cfg = TrainConfig(**tc["cfg"])
    res = {}
    batches = [part.partition_graph(graph(g), world) for g in tc["graphs"]]
    for name, kw in (("partitioned", dict(strategy="partitioned",
                                          mesh=gmesh)),
                     ("dp", dict(strategy="dp", mesh=dmesh))):
        steps = (batches if name == "partitioned"
                 else [graph(b) for b in tc["dp_batches"]])
        m = model("edge", inputs["params"]["edge"], dims)
        t = Trainer(m, cfg, **kw)
        losses = t.run_steps(steps)
        res[name] = dict(losses=losses, params=_params(m).numpy())

    res["scan"] = _scan_cases(inputs, batches, [graph(b) for b in
                                                tc["dp_batches"]],
                              gmesh, dmesh)

    # bf16 on the fused body: finite logits and losses
    m = model("edge", inputs["params"]["edge"], dims, "fused", bf16=True)
    t = Trainer(m, cfg, strategy="partitioned", mesh=gmesh)
    pg = part.partition_graph(graphs["edge"], world, plans=True)
    bf16_losses = t.run_steps([pg] * 3)
    probs, _, _ = t.predict(iter([pg]), 1)
    res["bf16"] = dict(losses=bf16_losses, probs=probs)

    # fit with validation and checkpoints (rank 0 writes), then a fresh
    # Trainer on every rank resumes from them; evaluate on every rank
    ckpt = os.path.join(tc["directory"], "ckpt")
    m = model("edge", inputs["params"]["edge"], dims)
    t = Trainer(m, cfg, strategy="partitioned", mesh=gmesh,
                checkpoint_dir=ckpt,
                metrics_path=os.path.join(tc["directory"], "metrics.jsonl"))
    t.fit(iter(batches * 2), n_batches=2, n_epochs=2,
          valid_generator=iter(batches[:1] * 2), n_valid_batches=1)
    resumed = Trainer(model("edge", inputs["params"]["edge"], dims), cfg,
                      strategy="partitioned", mesh=gmesh,
                      checkpoint_dir=ckpt)
    loaded = resumed.load_checkpoint()
    res["fit"] = dict(
        train_losses=t.train_losses, valid_losses=t.valid_losses,
        loaded=loaded, epoch=resumed.epoch,
        same_params=bool(torch.equal(_params(resumed.model), _params(m))),
        metrics=t.evaluate(iter(batches), 2))
    return res


def _scan_cases(inputs, pgs, dp_batches, gmesh, dmesh) -> dict:
    """Each strategy's stacked steps (``run_steps`` on ``stack_batches``,
    each rank its part of axis 1 of the stack) under each of
    ``tc["scan"]``'s train configs, with the JAX masks where it asks for
    them; beside them the same steps one call a batch (``fit``, one step
    a call), which must give the same losses and weights bit for bit."""
    from gnn_fpga_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                                  stack_batches)

    dims = inputs["dims"]
    res = {}
    for name, case in inputs["trainer"]["scan"].items():
        kw = (dict(strategy="partitioned", mesh=gmesh)
              if case["strategy"] == "partitioned"
              else dict(strategy="dp", mesh=dmesh))
        steps = pgs if case["strategy"] == "partitioned" else dp_batches
        masks = _masks(inputs, case)
        cfg = TrainConfig(**case["cfg"])
        m = model("edge", inputs["params"]["edge"], dims)
        t = Trainer(m, cfg, masks=masks, **kw)
        losses = t.run_steps(stack_batches(steps))
        one = model("edge", inputs["params"]["edge"], dims)
        t1 = Trainer(one, cfg, masks=masks, **kw)
        t1.fit(iter(steps), n_batches=1, n_epochs=len(steps))
        res[name] = dict(
            losses=losses, params=_params(m).numpy(),
            one_step_losses=np.array(t1.train_losses, np.float32),
            one_step_params=_params(one).numpy(),
            last_epoch=None if t.scheduler is None
            else (t.scheduler.last_epoch, float(t.scheduler.count)),
            pruned=None if masks is None else [
                float(getattr(getattr(m, mod), k).weight[mk == 0].abs()
                      .sum()) for mod, layer in masks.items()
                for k, mk in layer.items() if mk is not None])
    return res


def _cli_cases(cli: dict) -> dict:
    """The train CLI on ``cli["graph_dir"]`` with each strategy, its model
    built with the JAX CLI's initial weights (``cli["params"]``)."""
    from gnn_fpga_tpu_torch.cli import train as ttrain
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.utils.serialization import load_jax_params

    init = mpnn.init_segment_classifier

    def from_jax(cfg, generator, device=None):
        m = init(cfg, generator, device)
        load_jax_params(m, cli["params"])
        return m

    mpnn.init_segment_classifier = from_jax
    res = {}
    try:
        for name, args in cli["runs"].items():
            t = ttrain.main(args)
            res[name] = dict(train_losses=t.train_losses,
                             valid_losses=t.valid_losses,
                             params=_params(t.model).numpy())
    finally:
        mpnn.init_segment_classifier = init
    return res

