"""Checkpoint / resume with best-model retention.

The counterpart of ``gnn_fpga_tpu/train/checkpoint.py``: every save writes
the training state and a JSON sidecar of scalar metadata and loss
histories under ``<directory>/checkpoint``, and under
``<directory>/model_best`` as well when validation improved.  The state
(model, optimizer and scheduler state dicts) goes through ``torch.save``
and is read back with ``torch.load(..., weights_only=True)``, which loads
tensors and plain containers only.  A save is written to a ``.tmp``
directory first and moved into place with ``os.replace``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

_LATEST = "checkpoint"
_BEST = "model_best"
_META = "meta.json"
_STATE = "state.pt"


class CheckpointManager:
    """Save/restore train state under a directory, keeping latest + best."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, state: Dict[str, Any], meta: Dict[str, Any],
             is_best: bool = False) -> None:
        """``state``: state dicts (model, optimizer, scheduler).
        ``meta``: JSON-serialisable scalars and lists (epoch, histories)."""
        self._save_one(state, meta, _LATEST)
        if is_best:
            self._save_one(state, meta, _BEST)

    def _save_one(self, state, meta, name):
        path = self._path(name)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

    def restore(self, best: bool = False
                ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """``(state, meta)`` with tensors on the CPU; None if absent."""
        path = self._path(_BEST if best else _LATEST)
        if not os.path.exists(path):
            return None
        state = torch.load(os.path.join(path, _STATE), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        return state, meta

    def exists(self, best: bool = False) -> bool:
        return os.path.exists(self._path(_BEST if best else _LATEST))
