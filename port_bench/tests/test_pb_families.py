"""Each configuration's model family, found by its ``model``, gives what the
harness read before the families were files of their own, bit for bit:
the weights drawn from a seed, the reference's logits and losses, the
forward's useful FLOPs and the kernels' shapes."""

import hashlib
import json

import pytest

from port_bench import gen, manifest, program, reference
from port_bench.tests.small import EVENTS, MIX

# recorded from the harness as it was before the move (reference.py and
# yardstick.py holding both networks), on the CPU, for the small event of
# _event: sha256 prefixes of the weights (name, shape and bytes, in the
# leaves' order) and of the logits' bytes, and the losses as float.hex
BEFORE = {
    "seg_h64i6": dict(weights="173fb249f0f746ff", logits="85c3015e53dc0a7c",
                      logits_fp8="0f803a098a419f37",
                      loss="0x1.81fb360000000p+0",
                      loss_bf16="0x1.81fc860000000p+0"),
    "hit_h64i7": dict(weights="d55e5cc25bbe6c17", logits="21254679880f32b7",
                      logits_fp8="553f9c788c155e72",
                      loss="0x1.3421480000000p-1",
                      loss_bf16="0x1.344df60000000p-1"),
}
# the kernels' shapes on each cell's first small batch (small.py's sizes),
# recorded the same way
SHAPES = {
    "seg_h64i6-event_train": dict(v=512, e=4096, d=66, hdim=64, dtype_bytes=2),
    "hit_h64i7-event_train": dict(v=512, e=4096, d=67, hdim=64, dtype_bytes=2),
    "seg_h64i6-event_infer_b16": dict(v=1024, e=8192, d=66, hdim=64,
                                      dtype_bytes=2),
    "seg_h64i6-sector_train_blocked": dict(v=100, e=720, d=66, hdim=64,
                                           dtype_bytes=2),
}


def _config(name: str) -> dict:
    cfg = json.loads((manifest.HERE / "configs" / f"{name}.json").read_text())
    cfg["events"].update(EVENTS)
    return cfg


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def _event(cfg: dict, n: int = 1, seed: int = 2**31 + 11) -> tuple:
    rngs, wseed = gen.streams(seed, n)
    return [gen.make_event(cfg["events"], r) for r in rngs], wseed


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_move_changes_no_reading(name):
    cfg = _config(name)
    (ev,), wseed = _event(cfg)
    w = reference.make_weights(cfg, wseed, "cpu")
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(f"{k}|{tuple(v.shape)}|".encode())
        h.update(v.numpy().tobytes())
    g = reference.graph_tensors(ev.packed(), "cpu")
    got = dict(
        weights=h.hexdigest()[:16],
        logits=_digest(reference.logits(w, g, cfg)),
        logits_fp8=_digest(reference.logits(
            w, g, cfg, reference.rounder("float8_e4m3"))),
        loss=float(reference.loss(w, g, cfg)).hex(),
        loss_bf16=float(reference.loss(
            w, g, cfg, reference.rounder("bfloat16"))).hex())
    assert got == BEFORE[name]


@pytest.mark.parametrize("workload", sorted(SHAPES))
def test_the_kernel_shapes_are_unchanged(workload):
    cell = manifest.load_cell(workload)
    cfg, mix = cell.config, dict(cell.traffic)
    cfg["events"].update(EVENTS)
    mix.update({k: v for k, v in MIX.items()
                if k in ("block_e", "events_per_batch") and k in mix})
    per = mix.get("events_per_batch", 1)
    events, _ = _event(cfg, 2 * per, 2**31 + 5)
    batches = program.one_signature(
        [program.layout(events[i:i + per], cfg["events"], mix)
         for i in range(0, len(events), per)])
    assert program.kernel_shapes(batches[0], cfg) == SHAPES[workload]


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_the_model_is_built_with_the_leaves_names(name):
    cfg = _config(name)
    fam = manifest.family(cfg["model"])
    w = reference.make_weights(cfg, 7, "cpu")
    model = program.make_model(cfg, {"route": "sparse"}, w, "cpu")
    assert [n for n, _, _ in fam.leaves(cfg)] == list(w)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: s for n, s, _ in fam.leaves(cfg)}
    with pytest.raises(ValueError, match="leaves"):
        program.make_model(cfg, {"route": "sparse"},
                           {k: v for k, v in w.items() if k != "input.bias"},
                           "cpu")


def test_an_unknown_model_names_the_files_looked_for():
    for lookup in (manifest.family, manifest.builder):
        with pytest.raises(KeyError) as err:
            lookup("interaction_gnn_x")
        for path in manifest.model_files("interaction_gnn_x").values():
            assert str(path) in str(err.value)
    with pytest.raises(KeyError, match="no model"):
        reference.make_weights({"model": "interaction_gnn_x"}, 1, "cpu")


@pytest.mark.parametrize("files, problem", [
    ({}, "no port_bench/families/ghost.py"),
    ({"families": "def leaves(cfg):\n    return []\n"},
     "families/ghost.py has no logits"),
    ({"families": "from port_bench.families.segment_classifier import *\n"},
     "no port_bench/builders/ghost.py"),
    ({"families": "from port_bench.families.segment_classifier import *\n",
      "builders": "def make_model(cfg, mix, device):\n    pass\n"},
     "builders/ghost.py has no kernel_shapes"),
])
def test_a_model_without_its_files_is_named(tmp_path, files, problem):
    from port_bench.tests.small import small_root

    root = small_root(tmp_path)
    pb = root / "port_bench"
    cfg = json.loads((pb / "configs" / "seg_h64i6.json").read_text())
    cfg.update(name="ghost_h64i6", model="ghost")
    (pb / "configs" / "ghost_h64i6.json").write_text(json.dumps(cfg))
    for kind, text in files.items():
        (pb / kind / "ghost.py").write_text(text)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="ghost_h64i6",
                               file="port_bench/configs/ghost_h64i6.json"))
    assert any(problem in p for p in manifest.problems(man, root)), \
        manifest.problems(man, root)
