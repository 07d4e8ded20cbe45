"""Static-shape batching for variable-size graphs.

The counterpart of ``gnn_fpga_tpu/core/batching.py``.  Batches are padded
to bucket shapes chosen once from the dataset, so every batch of a bucket
has one shape.  Selection uses the same ``np.random.default_rng`` calls as
the JAX package, so equal seeds give the same graphs in the same order.
Batches are built on the host and yielded as CPU graphs; move them to the
card with :meth:`Graph.to` or :mod:`gnn_fpga_tpu_torch.core.prefetch`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator, List, Sequence

import numpy as np

from gnn_fpga_tpu_torch.core.graph import (Graph, batch_graphs, pack_graphs,
                                           unbatch_graphs)


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static (n_node, n_edge) pad targets for one size bucket."""
    n_node: int
    n_edge: int


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _n_node(g: Graph) -> int:
    return int(g.x.shape[0])


def _n_edge(g: Graph) -> int:
    return int(g.senders.shape[0])


def choose_bucket(graphs: Sequence[Graph], node_multiple: int = 8,
                  edge_multiple: int = 128) -> BucketSpec:
    """One bucket covering every graph, rounded up to the given multiples,
    with one node slot more for the zero-feature pad node."""
    max_n = max(_n_node(g) for g in graphs) + 1
    max_e = max(_n_edge(g) for g in graphs)
    return BucketSpec(_round_up(max_n, node_multiple),
                      max(_round_up(max_e, edge_multiple), edge_multiple))


def choose_buckets(graphs: Sequence[Graph], n_buckets: int,
                   node_multiple: int = 8,
                   edge_multiple: int = 128) -> List[BucketSpec]:
    """Quantile-based size buckets over edge count; each bucket's spec
    covers its members."""
    sizes = np.array([_n_edge(g) for g in graphs])
    qs = np.quantile(sizes, np.linspace(0, 1, n_buckets + 1)[1:])
    specs = []
    for i, hi in enumerate(qs):
        lo = 0 if i == 0 else qs[i - 1]
        members = [g for g, s in zip(graphs, sizes)
                   if (s <= hi and (i == 0 or s > lo))]
        if members:
            specs.append(choose_bucket(members, node_multiple, edge_multiple))
    return specs


def assign_bucket(g: Graph, specs: Sequence[BucketSpec]) -> BucketSpec:
    """The smallest bucket (by edges) that holds ``g`` and its pad node."""
    n = _n_node(g) + 1
    e = _n_edge(g)
    for spec in sorted(specs, key=lambda s: s.n_edge):
        if n <= spec.n_node and e <= spec.n_edge:
            return spec
    raise ValueError(f"no bucket fits graph with {n - 1} nodes / {e} edges")


def _bucket_pools(graphs: Sequence[Graph], specs: Sequence[BucketSpec],
                  batch_size: int) -> List[tuple]:
    """``[(spec, indices)]``: graphs in their smallest fitting bucket; a
    pool too small for one batch is merged into the next larger bucket,
    whose spec grows to cover both on both axes.  A last undersized pool
    has nowhere to go: it is dropped with a warning."""
    ordered = sorted(specs, key=lambda s: (s.n_edge, s.n_node))
    pools: List[List[int]] = [[] for _ in ordered]
    for gi, g in enumerate(graphs):
        spec = assign_bucket(g, ordered)
        pools[ordered.index(spec)].append(gi)
    for i in range(len(ordered) - 1):
        if 0 < len(pools[i]) < batch_size:
            pools[i + 1] = pools[i] + pools[i + 1]
            pools[i] = []
            ordered[i + 1] = BucketSpec(
                n_node=max(ordered[i].n_node, ordered[i + 1].n_node),
                n_edge=max(ordered[i].n_edge, ordered[i + 1].n_edge))
    if 0 < len(pools[-1]) < batch_size:
        warnings.warn(
            f"bucket {ordered[-1]} holds {len(pools[-1])} graphs < "
            f"batch_size={batch_size}; they are excluded from every epoch "
            f"(use fewer buckets or a smaller batch size)",
            stacklevel=3)
    return [(spec, np.array(pool))
            for spec, pool in zip(ordered, pools) if len(pool) >= batch_size]


def batch_generator(graphs, batch_size: int, bucket=None,
                    shuffle: bool = True, seed: int = 0,
                    packed: bool = False, transform=None) -> Iterator[Graph]:
    """Infinite generator of static-shape batches on the host.

    ``packed=False`` yields a batched Graph ``[B, ...]``; ``packed=True``
    one flat packed graph of ``B`` events.  ``bucket`` is one
    :class:`BucketSpec`, a sequence of them (:func:`choose_buckets`: each
    graph goes to its smallest fitting bucket), or None (one bucket
    covering every graph).  ``graphs`` is a list of single graphs or one
    batched Graph, which is split first.  ``transform(batch, indices)``,
    when given, maps every batch, with the indices into ``graphs`` of its
    graphs in pack/stack order (the hook that attaches plans).
    """
    if isinstance(graphs, Graph):
        graphs = unbatch_graphs(graphs)
    if bucket is None:
        bucket = choose_bucket(graphs)
    specs = list(bucket) if isinstance(bucket, (list, tuple)) else [bucket]
    pools = _bucket_pools(graphs, specs, batch_size)
    if not pools:
        raise ValueError("fewer graphs than batch_size")
    rng = np.random.default_rng(seed)

    def emit(spec: BucketSpec, sel) -> Graph:
        chunk = [graphs[i] for i in sel]
        if packed:
            batch = pack_graphs(chunk, n_node=spec.n_node * batch_size,
                                n_edge=spec.n_edge * batch_size)
        else:
            batch = batch_graphs(chunk, spec.n_node, spec.n_edge)
        if transform is not None:
            batch = transform(batch, list(sel))
        return batch

    while True:
        plan = []
        for spec, pool in pools:
            order = rng.permutation(pool) if shuffle else pool
            for b in range(len(pool) // batch_size):
                plan.append((spec, order[b * batch_size:(b + 1) * batch_size]))
        if shuffle:
            rng.shuffle(plan)
        for spec, sel in plan:
            yield emit(spec, sel)


def padding_efficiency(graphs, bucket, batch_size: int) -> float:
    """Fraction of padded edge slots holding real edges under the given
    bucket(s)."""
    if isinstance(graphs, Graph):
        graphs = unbatch_graphs(graphs)
    specs = list(bucket) if isinstance(bucket, (list, tuple)) else [bucket]
    pools = _bucket_pools(graphs, specs, batch_size)
    real = padded = 0
    for spec, pool in pools:
        n_full = len(pool) // batch_size
        used = pool[: n_full * batch_size]
        real += sum(int(graphs[i].edge_mask.sum()) for i in used)
        padded += n_full * batch_size * spec.n_edge
    return real / max(padded, 1)


def n_batches_per_epoch(n_graphs: int, batch_size: int) -> int:
    return n_graphs // batch_size
