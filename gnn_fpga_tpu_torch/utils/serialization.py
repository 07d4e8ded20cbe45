"""Carrying weights across to and from the JAX package.

``load_params_npz`` reads the parameter NPZ that the JAX package writes
(``leaf_<i>`` arrays plus a JSON key-path table, or the older keystr
format) into nested dicts of numpy arrays, with numpy alone, and
``save_params_npz`` writes that format.  ``load_jax_params`` fills a
model of :mod:`gnn_fpga_tpu_torch.models.mpnn` from such a tree,
``to_jax_params`` is its inverse, and ``load_jax_masks`` converts a JAX
pruning-mask tree to the port's layout.  The tree follows the model:

- SegmentClassifier: ``input``, ``edge``, ``node``;
- NodeClassifier: the same and ``output`` (a ``[d, 1]`` layer);
- SegmentClassifierUnshared: ``input``, ``edge_stack`` and ``node_stack``
  (an edge and a node network whose leaves are stacked ``[n_iters, ...]``)
  and ``output`` (an edge network).

JAX stores a weight as ``[in, out]``, ``nn.Linear`` as ``[out, in]``; the
JAX edge network's first layer ``[2D, H]`` becomes the port's
sender/receiver halves ``pa``/``pb``.

The GCN classifier (:mod:`~gnn_fpga_tpu_torch.models.gcn`) and the
baselines (:mod:`~gnn_fpga_tpu_torch.models.baselines`) mirror their JAX
trees: a submodule or parameter per key, an ``nn.ModuleList`` per list,
and a layer (a submodule with a ``weight``) per ``{"w", "b"}``, its weight
transposed (a linear layer) or HWIO <-> ``[out, in, kh, kw]`` (a conv); a
bare parameter (the LSTM's) keeps the JAX layout.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch import nn

from gnn_fpga_tpu_torch.core.device import default_device

_PATHS_KEY = "__tree_paths__"


def _insert(root, path, value):
    node = root
    for i, (kind, key) in enumerate(path):
        last = i == len(path) - 1
        if kind in ("d", "a", "f"):
            if last:
                node[key] = value
            else:
                node = node.setdefault(key, {})
        elif kind == "s":
            # sequences are dicts keyed by ("seq", i) until _fix_sequences
            if last:
                node[("seq", key)] = value
            else:
                node = node.setdefault(("seq", key), {})
        else:
            raise ValueError(f"unknown path entry kind {kind!r}")
    return root


def _fix_sequences(node):
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(isinstance(k, tuple) and k and k[0] == "seq" for k in keys):
        items = sorted(node.items(), key=lambda kv: kv[0][1])
        return [_fix_sequences(v) for _, v in items]
    return {k: _fix_sequences(v) for k, v in node.items()}


def _load_keystr_format(flat: dict):
    """Flat keys like ``['edge']['l1']['w']`` (plain dict layouts only)."""
    params: dict = {}
    for keystr, arr in flat.items():
        keys = [k.strip("'\"") for k in keystr.replace("]", "").split("[") if k]
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return params


def load_params_npz(path):
    """Read a parameter tree written by the JAX package's
    ``save_params_npz`` (or its older keystr format) as numpy arrays."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    if _PATHS_KEY not in data:
        return _load_keystr_format(data)
    spec = json.loads(bytes(data[_PATHS_KEY].tobytes()).decode("utf-8"))
    root: dict = {}
    for i, path_entries in enumerate(spec):
        _insert(root, [(e[0], e[1]) for e in path_entries], data[f"leaf_{i}"])
    return _fix_sequences(root)


def _flatten_with_paths(node, path=()):
    """``(path, leaf)`` pairs in the JAX package's flattening order: dict
    keys sorted, sequences in order; a path entry is ``["d", key]`` or
    ``["s", index]``."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _flatten_with_paths(node[k], path + (["d", k],))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten_with_paths(v, path + (["s", i],))
    else:
        yield list(path), np.asarray(node)


def save_params_npz(path, params) -> None:
    """Write a nested dict/list tree of arrays as the JAX package's
    ``save_params_npz`` does (``leaf_<i>`` arrays plus the JSON key-path
    table), so that its ``load_params_npz`` reads it."""
    flat = list(_flatten_with_paths(params))
    arrays = {f"leaf_{i}": leaf for i, (_, leaf) in enumerate(flat)}
    spec = [p for p, _ in flat]
    encoded = np.frombuffer(json.dumps(spec).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays, **{_PATHS_KEY: encoded})


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _split_edge_l1(w1, d):
    """JAX ``[2D, H]`` first edge layer -> port ``pa``/``pb`` ``[H, D]``."""
    w1 = _f32(w1)
    if w1.shape[0] != 2 * d:
        raise ValueError(f"edge l1 weight has {w1.shape[0]} rows, "
                         f"expected 2 * {d}")
    return w1[:d].T, w1[d:].T


def _linear_state(prefix, p) -> dict:
    return {f"{prefix}.weight": _f32(p["w"]).T, f"{prefix}.bias": p["b"]}


def _edge_state(prefix, p, d) -> dict:
    wa, wb = _split_edge_l1(p["l1"]["w"], d)
    return {f"{prefix}.pa.weight": wa, f"{prefix}.pb.weight": wb,
            f"{prefix}.b1": p["l1"]["b"],
            **_linear_state(f"{prefix}.l2", p["l2"])}


def _node_state(prefix, p) -> dict:
    return {**_linear_state(f"{prefix}.l1", p["l1"]),
            **_linear_state(f"{prefix}.l2", p["l2"])}


def _unstack(tree, i):
    """Iteration ``i`` of a stacked ``[n_iters, ...]`` tree."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _jax_state(model, params) -> dict:
    """The port's state dict (numpy) of a JAX parameter tree of
    ``model``'s kind."""
    from gnn_fpga_tpu_torch.models.mpnn import SegmentClassifierUnshared

    d = model.cfg.input_dim + model.cfg.hidden_dim
    state = _linear_state("input", params["input"])
    if isinstance(model, SegmentClassifierUnshared):
        n = model.cfg.n_iters
        for key in ("edge_stack", "node_stack"):
            got = np.asarray(params[key]["l1"]["w"]).shape[0]
            if got != n:
                raise ValueError(f"{key} stacks {got} iterations, the "
                                 f"model has {n}")
        for i in range(n):
            state.update(_edge_state(f"edge_stack.{i}",
                                     _unstack(params["edge_stack"], i), d))
            state.update(_node_state(f"node_stack.{i}",
                                     _unstack(params["node_stack"], i)))
        state.update(_edge_state("output", params["output"], d))
        return state
    state.update(_edge_state("edge", params["edge"], d))
    state.update(_node_state("node", params["node"]))
    if "output" in params:
        state.update(_linear_state("output", params["output"]))
    return state


def _from_jax_weight(w) -> np.ndarray:
    w = _f32(w)
    return w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)


def _to_jax_weight(w) -> np.ndarray:
    return w.T.copy() if w.ndim == 2 else w.transpose(2, 3, 1, 0).copy()


def _keys_must_match(tree, keys, where) -> None:
    if not isinstance(tree, dict) or set(tree) != set(keys):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"the JAX tree at {where or 'the root'!r} holds "
                         f"{got}, the model {sorted(keys)}")


def _mirror_state(module: nn.Module, tree, prefix: str = "") -> dict:
    """The port's state dict (numpy) of a JAX tree that mirrors
    ``module`` (a GCN or baseline model)."""
    own = dict(module.named_parameters(recurse=False))
    if "weight" in own:
        _keys_must_match(tree, ["w"] + (["b"] if "bias" in own else []),
                         prefix)
        state = {f"{prefix}weight": _from_jax_weight(tree["w"])}
        if "bias" in own:
            state[f"{prefix}bias"] = tree["b"]
        return state
    if isinstance(module, nn.ModuleList):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(module):
            raise ValueError(f"the JAX tree at {prefix!r} is not a list of "
                             f"{len(module)}")
        children = [(str(i), m, tree[i]) for i, m in enumerate(module)]
    else:
        kids = dict(module.named_children())
        _keys_must_match(tree, list(own) + list(kids), prefix)
        children = [(k, m, tree[k]) for k, m in kids.items()]
    state = {f"{prefix}{k}": tree[k] for k in own}
    for k, m, sub in children:
        state.update(_mirror_state(m, sub, f"{prefix}{k}."))
    return state


def _mirror_tree(module: nn.Module):
    """The JAX tree of a module that mirrors it (the inverse of
    :func:`_mirror_state`), float32 numpy."""
    own = {k: p.detach().float().cpu().numpy()
           for k, p in module.named_parameters(recurse=False)}
    if "weight" in own:
        layer = {"w": _to_jax_weight(own["weight"])}
        if "bias" in own:
            layer["b"] = own["bias"]
        return layer
    if isinstance(module, nn.ModuleList):
        return [_mirror_tree(m) for m in module]
    own.update((k, _mirror_tree(m)) for k, m in module.named_children())
    return own


def _is_mpnn_head(model) -> bool:
    from gnn_fpga_tpu_torch.models.mpnn import _Model

    return isinstance(model, _Model)


def load_jax_params(model, params) -> None:
    """Copy a JAX parameter tree (numpy arrays) of ``model``'s kind (a
    SegmentClassifier, SegmentClassifierUnshared or NodeClassifier, a GCN
    classifier or a baseline) into ``model`` in place."""
    state = (_jax_state(model, params) if _is_mpnn_head(model)
             else _mirror_state(model, params))
    names = [n for n, _ in model.named_parameters()]
    if set(state) != set(names):
        raise ValueError(
            f"the JAX tree does not fit {type(model).__name__}: missing "
            f"{sorted(set(names) - set(state))}, extra "
            f"{sorted(set(state) - set(names))}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = torch.from_numpy(np.array(_f32(state[name])))
            if src.shape != p.shape:
                raise ValueError(f"{name}: JAX shape {tuple(src.shape)} "
                                 f"does not fit {tuple(p.shape)}")
            p.copy_(src)


def to_jax_params(model) -> dict:
    """The JAX package's parameter tree of ``model`` as float32 numpy
    arrays (the inverse of :func:`load_jax_params`): weights ``[in, out]``,
    ``pa``/``pb`` joined into the edge network's ``[2D, H]`` first layer,
    the unshared head's per-iteration networks stacked ``[n_iters, ...]``;
    a GCN classifier's or a baseline's mirrored tree."""
    from gnn_fpga_tpu_torch.models.mpnn import SegmentClassifierUnshared

    if not _is_mpnn_head(model):
        return _mirror_tree(model)
    t = {name: p.detach().float().cpu().numpy()
         for name, p in model.named_parameters()}
    lin = lambda n: {"w": t[f"{n}.weight"].T.copy(), "b": t[f"{n}.bias"]}
    edge = lambda n: {"l1": {"w": np.concatenate([t[f"{n}.pa.weight"].T,
                                                  t[f"{n}.pb.weight"].T]),
                             "b": t[f"{n}.b1"]},
                      "l2": lin(f"{n}.l2")}
    node = lambda n: {"l1": lin(f"{n}.l1"), "l2": lin(f"{n}.l2")}
    if isinstance(model, SegmentClassifierUnshared):
        stack = lambda trees: {k: stack([tr[k] for tr in trees])
                               if isinstance(trees[0][k], dict)
                               else np.stack([tr[k] for tr in trees])
                               for k in trees[0]}
        n = model.cfg.n_iters
        return {"input": lin("input"),
                "edge_stack": stack([edge(f"edge_stack.{i}")
                                     for i in range(n)]),
                "node_stack": stack([node(f"node_stack.{i}")
                                     for i in range(n)]),
                "output": edge("output")}
    tree = {"input": lin("input"), "edge": edge("edge"), "node": node("node")}
    if "output.weight" in t:
        tree["output"] = lin("output")
    return tree


def load_jax_masks(masks, input_dim: int, hidden_dim: int, device=None):
    """Convert a JAX mask tree (``{"edge": {"l1", "l2"}, "node": {"l1",
    "l2"}}``, ``[in, out]``, as the JAX package's pruning writes it for a
    SegmentClassifier or a NodeClassifier) to the port's mask dict of
    tensors on ``device`` (the CUDA device when it is None, as the models'
    own default)."""
    d = input_dim + hidden_dim
    out = {}
    device = default_device(device)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    if "edge" in masks:
        em = masks["edge"]
        out["edge"] = {}
        if em.get("l1") is not None:
            wa, wb = _split_edge_l1(em["l1"], d)
            out["edge"]["pa"], out["edge"]["pb"] = t(wa), t(wb)
        if em.get("l2") is not None:
            out["edge"]["l2"] = t(_f32(em["l2"]).T)
    if "node" in masks:
        out["node"] = {k: t(_f32(m).T) for k, m in masks["node"].items()
                       if m is not None}
    return out
