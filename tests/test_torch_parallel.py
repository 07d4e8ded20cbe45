"""The port's parallel package in one process against the JAX package's:
``partition_graph`` bit for bit, the shards' plans over their extended
tables, ``multihost``'s arithmetic and initialisation, the mesh helpers
in a world of one, the train CLI's strategy checks and its pre-scan of
every split, and the three examples at tiny sizes on the CPU.  The
multi-rank checks are in ``tests/test_torch_parallel_ranks.py``."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.parallel import multihost as jmulti
from gnn_fpga_tpu.parallel import partition as jpart
from gnn_fpga_tpu_torch.cli import train as ttrain
from gnn_fpga_tpu_torch.core import batching as tb
from gnn_fpga_tpu_torch.core import graph as tg
from gnn_fpga_tpu_torch.ops.cuda import spmm
from gnn_fpga_tpu_torch.parallel import mesh as tmesh
from gnn_fpga_tpu_torch.parallel import multihost as tmulti
from gnn_fpga_tpu_torch.parallel import partition as tpart

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ("x", "senders", "receivers", "y", "edge_mask", "node_mask",
          "senders_ext", "send_idx", "node_y")


def _jax_graph(n_layers=8, n_tracks=6, seed=0, node_y=False):
    cfg = jtoy.Toy2DConfig(n_layers=n_layers, n_tracks=n_tracks, seed=seed)
    g = jax.tree.map(lambda a: np.asarray(a[0]),
                     jtoy.make_segment_graphs(cfg, 1))
    if node_y:
        rng = np.random.default_rng(seed)
        g = g.replace(node_y=rng.integers(0, 2, g.n_node).astype(np.float32))
    return g


def _port(g) -> tg.Graph:
    return tg.Graph(**{k: None if getattr(g, k) is None
                       else torch.from_numpy(np.array(getattr(g, k)))
                       for k in ("x", "senders", "receivers", "y",
                                 "node_mask", "edge_mask", "node_y")})


def _padded(g):
    """The graph padded to 53 nodes (not a multiple of 2, 4 or 8) and 300
    edges (masked pad edges on node 48)."""
    return tg.pad_graph(_port(g), 53, 300)


def _assert_same_arrays(want, got):
    for k in ARRAYS:
        a, b = getattr(want, k), getattr(got, k)
        if a is None:
            assert b is None, k
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("n_parts", [2, 4, 8])
@pytest.mark.parametrize("kind", ["toy", "padded", "node_y"])
def test_partition_graph_matches_jax_bit_for_bit(n_parts, kind):
    g = _jax_graph(node_y=kind == "node_y")
    t = _padded(g) if kind == "padded" else _port(g)
    want = jpart.partition_graph(g if kind != "padded" else t, n_parts)
    for plans in (False, True):
        got = tpart.partition_graph(t, n_parts, plans=plans)
        _assert_same_arrays(want, got)
        assert got.n_parts == n_parts and got.halo_size == want.halo_size


@pytest.mark.parametrize("n_parts", [2, 4])
def test_partition_capacities_pin_shapes_and_raise_below(n_parts):
    g = _jax_graph()
    t = _port(g)
    free = jpart.partition_graph(g, n_parts)
    e_cap, s_cap = free.senders.shape[1] + 13, free.halo_size + 5
    want = jpart.partition_graph(g, n_parts, edge_capacity=e_cap,
                                 halo_capacity=s_cap)
    got = tpart.partition_graph(t, n_parts, edge_capacity=e_cap,
                                halo_capacity=s_cap)
    _assert_same_arrays(want, got)
    assert got.senders.shape[1] == e_cap
    assert got.halo_size == -(-s_cap // 8) * 8
    for kw in (dict(edge_capacity=free.senders.shape[1] - 1),
               dict(halo_capacity=free.halo_size - 8)):
        with pytest.raises(ValueError, match="capacity"):
            jpart.partition_graph(g, n_parts, **kw)
        with pytest.raises(ValueError, match="capacity"):
            tpart.partition_graph(t, n_parts, **kw)


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_shard_plans_are_the_extended_tables_plans(n_parts):
    """Each shard's plans are ``build_agg_plans`` over its local + halo
    extended table (senders_ext, local receivers), padded to the capacity
    that covers every shard; a smaller capacity raises."""
    t = _padded(_jax_graph())
    pg = tpart.partition_graph(t, n_parts, plans=True)
    n_ext = pg.n_local + pg.send_idx.shape[1]
    own = [spmm.build_agg_plans(pg.senders_ext[p].numpy(),
                                pg.receivers[p].numpy(), n_ext)
           for p in range(n_parts)]
    cap = spmm.PlanCapacity.covering(*own)
    assert tpart.shard_capacity(pg) == cap
    for p in range(n_parts):
        want, got = spmm.pad_plans(own[p], cap), pg.shard(p).plans
        assert got.recv.n_node == n_ext and got.recv.n_edge == pg.senders.shape[1]
        for a, b in zip(want.tensors(), got.tensors()):
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    small = dataclasses.replace(cap, recv_items=cap.recv_items - 1)
    with pytest.raises(ValueError, match="capacity"):
        tpart.partition_graph(t, n_parts, plans=True, capacity=small)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
def test_local_shard_and_host_slice_match_jax(count):
    items = [f"g{i:03d}.npz" for i in range(29)]
    for pid in range(count):
        assert tmulti.local_shard(items, pid, count) == \
            jmulti.local_shard(items, pid, count)
        assert tmulti.host_slice(8 * count, pid, count) == \
            jmulti.host_slice(8 * count, pid, count)
    if count > 1:
        with pytest.raises(ValueError):
            tmulti.host_slice(8 * count + 1, 0, count)


def test_initialize_is_a_noop_without_a_launcher_and_idempotent(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    tmulti.initialize()
    tmulti.initialize()
    assert not dist.is_initialized()
    assert tmulti.process_info() == {"process_id": 0, "process_count": 1,
                                     "local_devices": 1, "global_devices": 1}
    assert tmulti.local_shard([1, 2, 3]) == [1, 2, 3]
    with pytest.raises(ValueError, match="together"):
        tmulti.initialize("localhost:1234")
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(device="cpu")


@pytest.fixture
def world_of_one():
    assert not dist.is_initialized()
    tmulti.initialize_single("gloo")
    tmulti.initialize_single("gloo")       # a second call joins nothing
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_helpers_in_a_world_of_one(world_of_one):
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_mesh((1, 1), (tmesh.DATA_AXIS, tmesh.GRAPH_AXIS),
                           device="cpu")
    assert mesh.mesh_dim_names == ("data", "graph")
    assert tmesh.replicated(mesh) == (Replicate(), Replicate())
    assert tmesh.batch_sharded(mesh, "graph") == (Replicate(), Shard(0))
    batch = tg.batch_graphs(tg.unbatch_graphs(_port_batch()))
    local = tmesh.shard_batch(batch, mesh, tmesh.DATA_AXIS)
    for a, b in zip(batch.tensors(), local.tensors()):
        assert torch.equal(a, b)
    assert tmulti.global_batch_to_device(np.ones(3), mesh).device.type == "cpu"
    with pytest.raises(ValueError, match="axis sizes"):
        tmesh.make_mesh((2,), device="cpu")


def _port_batch():
    from gnn_fpga_tpu_torch.data import toy2d

    return toy2d.make_segment_graphs(
        toy2d.Toy2DConfig(n_layers=5, n_tracks=3, seed=0), 4)


@pytest.mark.parametrize("strategy,agg", [
    ("partitioned", "blocked"), ("partitioned", "dense"), ("dp", "pallas")])
def test_train_cli_refuses_strategy_and_route_before_loading(strategy, agg,
                                                             tmp_path):
    with pytest.raises(ValueError, match="does not combine"):
        ttrain.main(["--input-dir", str(tmp_path / "none"), "--strategy",
                     strategy, "--aggregation", agg, "--device", "cpu"])


def _sized_graphs(n_graphs, n_edge, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        s = rng.integers(0, 40, n_edge)
        r = rng.integers(0, 40, n_edge)
        out.append(tg.from_coo(rng.normal(size=(40, 3)), s, r,
                               (rng.random(n_edge) < 0.3).astype(np.float32)))
    return out


@pytest.mark.parametrize("plans", [False, True])
def test_partition_setup_scans_every_split(plans):
    """A valid batch far larger than any train batch: the capacities from
    every split cover it, those from the train split alone do not (the
    JAX CLI's pre-scan)."""
    train = _sized_graphs(4, 30, 0)
    valid = _sized_graphs(2, 400, 1)
    bucket = tb.choose_bucket(train + valid, edge_multiple=256)
    big = next(tb.batch_generator(valid, 2, bucket, shuffle=False,
                                  packed=True))
    every = ttrain.PartitionSetup([train, valid], bucket, 2, 2, plans)
    pg = every.transform(big, [0, 1])
    assert pg.senders.shape[1] == every.edge_capacity
    if plans:
        assert every.capacity.covers(spmm.PlanCapacity.covering(
            *(pg.shard(p).plans for p in range(2))))
    only_train = ttrain.PartitionSetup([train, []], bucket, 2, 2, plans)
    with pytest.raises(ValueError, match="capacity"):
        only_train.transform(big, [0, 1])


def test_plan_capacity_headroom_gives_zero_counts_room():
    """1.25x each count, rounded up, and room for one split (two slots)
    and one long segment a direction where a plan had none."""
    cap = spmm.PlanCapacity(recv_items=100, send_items=9, splits=0, slots=0,
                            recv_long=0, send_long=3)
    assert cap.with_headroom(1.25) == spmm.PlanCapacity(
        recv_items=125, send_items=12, splits=1, slots=2, recv_long=1,
        send_long=5)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_toy2d_example_runs_on_the_cpu(tmp_path):
    metrics = _example("train_toy2d_torch").main(
        ["--epochs", "1", "--events", "128", "--hidden-dim", "4",
         "--n-iters", "1", "--out", str(tmp_path), "--device", "cpu"])
    assert 0.0 <= metrics["accuracy"] <= 1.0
    assert {"roc.png", "losses.png", "event.png"} <= {
        p.name for p in tmp_path.iterdir()}


def test_pruning_rounds_example_runs_on_the_cpu():
    masks, metrics = _example("pruning_rounds_torch").main(
        ["--rounds", "1", "--epochs", "1", "--threshold", "0.2",
         "--device", "cpu"])
    assert set(masks) == {"edge", "node"}
    assert 0.0 <= metrics["accuracy"] <= 1.0


def test_partitioned_example_runs_in_a_world_of_one():
    trainer = _example("partitioned_mu200_torch").main(
        ["--n-tracks", "4", "--steps", "3", "--hidden-dim", "8",
         "--n-iters", "2", "--device", "cpu"])
    assert np.isfinite(trainer.train_losses).all()
    assert not dist.is_initialized()
