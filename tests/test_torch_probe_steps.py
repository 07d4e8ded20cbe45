"""The port's measurement modules (``gnn_fpga_tpu_torch/probes/blocked.py``,
``spmm.py``, ``doublets.py``, ``windowcut.py``) against the TPU probes
under ``benchmarks/`` and the JAX package, on the CPU at small sizes:
the inputs each builds (stacks, doublet graphs, splits) field for field,
the functions each times against the TPU probe's own (the JAX side's
kernels in interpret mode), and the steps each trains against the JAX
Trainer's losses from the same weights (the modules start from the JAX
package's ``PRNGKey(0)`` draw, ``utils/prng.py``), in f32.  The modules' widths are patched down where the JAX side runs
Pallas kernels in interpret mode.  The scaling harness is in
``tests/test_torch_scaling.py``; the card's runs are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py --phase probe_steps``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from benchmarks import probe_blocked as jprobe_blocked
from benchmarks import probe_doublets as jprobe_doublets
from benchmarks import probe_spmm as jprobe_spmm
from benchmarks import probe_windowcut as jprobe_windowcut
from gnn_fpga_tpu.data import toy2d as jtoy
from gnn_fpga_tpu.models import mpnn as jm
from gnn_fpga_tpu.ops.pallas import spmm as jsp
from gnn_fpga_tpu.train import trainer as jtrainer
from gnn_fpga_tpu_torch.data import toy2d
from gnn_fpga_tpu_torch.probes import blocked, doublets, windowcut
from gnn_fpga_tpu_torch.probes import spmm as spmm_probe
from gnn_fpga_tpu_torch.train.trainer import stack_batches
from gnn_fpga_tpu_torch.utils import prng
from gnn_fpga_tpu_torch.utils import serialization as tser

LOSS_TOL = dict(rtol=1e-5)
# the pallas route against the JAX kernels in interpret mode over two
# steps (summation order only, f32)
FUSED_LOSS_TOL = dict(rtol=1e-4)
OP_TOL = dict(rtol=1e-4, atol=1e-5)
GRAPH_FIELDS = ("x", "senders", "receivers", "y", "node_mask", "edge_mask")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's side: the suite runs several
    workers on the machine's cores, and the tiny ops here only slow down
    with more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_fields_equal(port, jax_graph, fields=GRAPH_FIELDS):
    for k in fields:
        got, want = getattr(port, k).numpy(), np.asarray(getattr(jax_graph,
                                                                 k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _jax_init(model, jax_model_cfg):
    """The JAX package's weights of ``jax_model_cfg`` from ``PRNGKey(0)``,
    which ``model`` (a module's, from ``probes.common.segment_classifier``)
    must hold already, bit for bit."""
    params = jm.init_segment_classifier(jax.random.PRNGKey(0),
                                        jax_model_cfg)
    got = tser.to_jax_params(model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    return params


def _jax_trainer(cfg_j, params, **tcfg):
    return jtrainer.Trainer(
        lambda p, g, m: jm.segment_classifier_logits(p, g, cfg_j, m),
        params, jtrainer.TrainConfig(**tcfg))


# ---------------------------------------------------------------------------
# The initial weights: the JAX package's PRNGKey draw, without JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5])
def test_prng_key_split_and_uniform_equal_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.prng_key(seed), np.asarray(key))
    np.testing.assert_array_equal(prng.split(prng.prng_key(seed), 5),
                                  np.asarray(jax.random.split(key, 5)))
    bound = 1 / np.sqrt(np.float32(198))
    for shape in [(1,), (5,), (3, 4), (198, 64), (4096,)]:
        for lo, hi in [(-bound, bound), (0.0, 1.0), (-0.3, 0.3)]:
            np.testing.assert_array_equal(
                prng.uniform(prng.prng_key(seed), shape, lo, hi),
                np.asarray(jax.random.uniform(key, shape, jnp.float32, lo,
                                              hi)))


@pytest.mark.parametrize("input_dim,hidden_dim", [(2, 64), (3, 32), (3, 64),
                                                  (2, 8)])
def test_segment_classifier_params_equal_the_jax_init(input_dim,
                                                      hidden_dim):
    cfg = jm.SegmentClassifierConfig(input_dim=input_dim,
                                     hidden_dim=hidden_dim)
    for seed in (0, 3):
        want = jm.init_segment_classifier(jax.random.PRNGKey(seed), cfg)
        got = prng.segment_classifier_params(seed, input_dim, hidden_dim)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("init", ["jax", "torch"])
def test_probe_models_start_from_the_chosen_draw(init):
    """``common.segment_classifier``: ``init="jax"`` holds the JAX
    package's ``PRNGKey(seed)`` weights, ``init="torch"`` the port's own
    ``torch.Generator().manual_seed(seed)`` draw; another name raises."""
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.probes import common

    cfg = mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=8, n_iters=2)
    got = common.segment_classifier(cfg, "cpu", seed=2, init=init)
    if init == "jax":
        want = prng.segment_classifier_params(2, 3, 8)
        for a, b in zip(jax.tree.leaves(tser.to_jax_params(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)
    else:
        want = mpnn.init_segment_classifier(
            cfg, torch.Generator().manual_seed(2), device="cpu")
        for a, b in zip(got.parameters(), want.parameters()):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        common.segment_classifier(cfg, "cpu", init="numpy")


# ---------------------------------------------------------------------------
# probes.blocked
# ---------------------------------------------------------------------------

CFG = dict(n_layers=6, n_tracks=4)


@pytest.mark.parametrize("group", [None, 1, 2])
def test_blocked_stack_equals_the_tpu_probe_field_for_field(group):
    be = None if group is None else blocked.block_e(group, CFG["n_tracks"])
    got = blocked.make_stacked(toy2d.Toy2DConfig(**CFG), 2, 2, 0,
                               group=group, block_e=be, device="cpu")
    want = jprobe_blocked.make_stacked(jtoy.Toy2DConfig(**CFG), 2, 2, 0,
                                       group=group, block_e=be)
    assert got.x.shape[:2] == (2, 2)
    _assert_fields_equal(got, want)
    if group is None:
        assert got.blocks is None and want.blocks is None
        return
    _assert_fields_equal(got.blocks, want.blocks,
                         ("block_nodes", "src_local", "dst_local"))


@pytest.mark.parametrize("route,group", [("dense", None), ("blocked", 2),
                                         ("sparse", None)])
def test_blocked_probe_steps_match_the_jax_trainer(route, group):
    """Two ``run_steps`` calls on a 2-step stack (the probe's timed unit)
    at the probe's TrainConfig, f32, from the JAX weights: the JAX
    Trainer's losses."""
    be = None if group is None else blocked.block_e(group, CFG["n_tracks"])
    stack = blocked.make_stacked(toy2d.Toy2DConfig(**CFG), 2, 2, 0,
                                 group=group, block_e=be, device="cpu")
    jstack = jprobe_blocked.make_stacked(jtoy.Toy2DConfig(**CFG), 2, 2, 0,
                                         group=group, block_e=be)
    tr = blocked.make_trainer(route, 8, 2, "cpu", compute_dtype=None)
    params = _jax_init(tr.model, jm.SegmentClassifierConfig(
        input_dim=2, hidden_dim=8, n_iters=2, aggregation=route))
    tr_j = _jax_trainer(jm.SegmentClassifierConfig(
        input_dim=2, hidden_dim=8, n_iters=2, aggregation=route), params,
        **blocked.TRAIN)
    got = np.concatenate([tr.run_steps(stack) for _ in range(2)])
    want = np.concatenate([np.asarray(tr_j.run_steps(jstack))
                           for _ in range(2)])
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_blocked_probe_main_prints_every_route(capsys, monkeypatch):
    monkeypatch.setitem(blocked.SCALES, "sector", (6, 4, 2, 1, True))
    monkeypatch.setattr(blocked, "HIDDEN", 8)
    monkeypatch.setattr(blocked, "N_ITERS", 2)
    out = blocked.main(["--metric", "sector", "--steps", "2", "--groups",
                        "1", "2", "--device", "cpu"])
    assert list(out["sector"]) == ["dense", "blocked group=1",
                                   "blocked group=2", "sparse"]
    for rec in out["sector"].values():
        assert np.isfinite(rec["loss"]) and rec["ms_per_step"] > 0
        assert rec["device_ms_per_step"] is None    # not measured on a CPU
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2])["routes"]["sparse"]["route"] == "sparse"
    assert lines[-1].startswith("# device: cpu")


# ---------------------------------------------------------------------------
# probes.spmm
# ---------------------------------------------------------------------------

def _jax_rows(h, w, pa, pb, g, s, r, v):
    """The TPU probe's functions (``benchmarks/probe_spmm.py:63-150``) on
    the same inputs, its kernels on plans of tile 256 in interpret
    mode."""
    sj, rj = jnp.asarray(s), jnp.asarray(r)
    pl = jsp.build_agg_plans(s, r, v, tile_e=256)

    def xla_pair(h, w):
        mi = jax.ops.segment_sum(jnp.take(h, sj, axis=0) * w[:, None], rj,
                                 num_segments=v)
        mo = jax.ops.segment_sum(jnp.take(h, rj, axis=0) * w[:, None], sj,
                                 num_segments=v)
        return mi + mo

    def fwdbwd(pair):
        def f(h, w):
            gh, gw = jax.grad(
                lambda h, w: jnp.sum(pair(h, w).astype(jnp.float32) ** 2),
                argnums=(0, 1))(h, w)
            return gh.astype(jnp.float32) + gw.sum()
        return f

    def pallas_pair(h, w):
        mi, mo = jsp.aggregate_pair(h, w, pl)
        return mi + mo

    xla_gp = lambda pa, pb: jnp.take(pa, sj, axis=0) + jnp.take(pb, rj,
                                                                  axis=0)
    gp = lambda a, b: jsp.gather_pair(a, b, sj, rj, pl)
    hw, ab, gh, gw = (h, w), (pa, pb), (g, h), (g, w)
    return {
        "sparse pair fwd": (xla_pair, hw),
        "sparse pair fwd+bwd": (fwdbwd(xla_pair), hw),
        "cuda aggregate_pair fwd": (pallas_pair, hw),
        "cuda aggregate_pair fwd+bwd": (fwdbwd(pallas_pair), hw),
        "plain gather_pair fwd": (xla_gp, ab),
        "plain gather_pair fwd+bwd": (fwdbwd(xla_gp), ab),
        "cuda gather_pair fwd": (gp, ab),
        "cuda gather_pair fwd+bwd": (fwdbwd(gp), ab),
        "sddmm_dual (full dw, one kernel)": (
            lambda a, b: jsp.sddmm_dual(a, b, a, b, pl.recv), gh),
        "sddmm single direction": (lambda a, b: jsp.sddmm(a, b, pl.recv),
                                   gh),
        "spmm single direction": (
            lambda a, ww: jsp._spmm_raw(a, ww, pl.send), gw),
    }


def test_spmm_probe_rows_match_the_tpu_probe_functions():
    """Every timed row of ``probes.spmm`` (V = 256, E = 1,024, D = 12,
    f32; on the CPU the kernels' plain versions) against the TPU probe's
    function of the same name on the same inputs."""
    v, e, d = 256, 1024, 12
    h, w, pa, pb, g, s, r, plans = spmm_probe.inputs(v, e, d, torch.float32,
                                                     "cpu")
    want = _jax_rows(*(jnp.asarray(t.numpy()) for t in (h, w, pa, pb, g)),
                     s.numpy(), r.numpy(), v)
    rows = spmm_probe.rows(h, w, pa, pb, g, s, r, plans)
    assert [name for name, *_ in rows] == list(want)
    with pltpu.force_tpu_interpret_mode():
        for name, fn, args, _ in rows:
            jfn, jargs = want[name]
            np.testing.assert_allclose(
                fn(*args).detach().numpy(), np.asarray(jfn(*jargs)),
                err_msg=name, **OP_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_probe_checks_pair_each_kernel_row_with_its_plain_version(
        dtype):
    """``probes.spmm.checks`` (what ``chip_smoke.py`` holds the kernels
    to on the card) names timed rows, and on the CPU, where each wrapper
    runs its plain version, each kernel call's outputs, the gradients of
    the fwd+bwd rows included, agree with the closed-form plain ones."""
    v, e, d = 256, 1024, 12
    args = spmm_probe.inputs(v, e, d, dtype, "cpu")
    checks = spmm_probe.checks(*args)
    names = [name for name, *_ in spmm_probe.rows(*args)]
    assert set(checks) <= set(names)
    assert {n for n in names if n.startswith("cuda")} <= set(checks)
    tol = OP_TOL if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-4)
    for name, (kern, plain, sides) in checks.items():
        got, want = kern(), plain()
        assert len(got) == len(want) == len(sides), name
        for side, a, b in zip(sides, got, want):
            np.testing.assert_allclose(
                a.detach().float().numpy(), b.float().numpy(),
                err_msg=f"{name} {side}", **tol)


def test_spmm_probe_inputs_are_the_tpu_probes():
    """The inputs of ``probes.spmm`` are the TPU probe's draws: ``h`` and
    ``w`` from its seed 1, in its order, on the layered graph."""
    v, e, d = 256, 1024, 12
    h, w, *_, s, r, _ = spmm_probe.inputs(v, e, d, torch.float32, "cpu")
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(
        h.numpy(), rng.standard_normal((v, d)).astype(np.float32))
    np.testing.assert_array_equal(
        w.numpy(), rng.standard_normal((e,)).astype(np.float32))
    js, jr = jprobe_spmm.layered_graph(v, e)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(r.numpy(), jr)


def test_spmm_probe_main_on_the_cpu(capsys):
    out = spmm_probe.main(["--v", "256", "--e", "1024", "--d", "12",
                           "--iters", "2", "--device", "cpu"])
    assert set(out) == {"float32", "bfloat16"}
    assert out["float32"]["max_abs_err"] < 1e-4
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "# device: cpu")


# ---------------------------------------------------------------------------
# probes.doublets
# ---------------------------------------------------------------------------

def test_doublet_event_equals_the_tpu_probes_dataframe():
    got = doublets.synth_event(np.random.default_rng(3), 40)
    want = jprobe_doublets.synth_event(np.random.default_rng(3), 40)
    assert got.columns == list(want.columns)
    for k in got.columns:
        w = want[k].to_numpy()
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def doublet_graphs():
    """``build_graphs`` of both probes, 2 events of 40 particles."""
    return (doublets.build_graphs(2, 40, device="cpu"),
            jprobe_doublets.build_graphs(2, 40))


def test_doublet_graphs_equal_the_tpu_probes(doublet_graphs):
    got, want = doublet_graphs
    assert len(got) == len(want) > 8
    for g, w in zip(got, want):
        _assert_fields_equal(g, w)


def test_doublet_fused_steps_match_the_tpu_probes_run(doublet_graphs,
                                                      monkeypatch):
    """Two fused-route steps (one ``run_steps`` call on a 2-step stack of
    packed sectors, 4 a step) at the probe's cosine rate and purity
    weight, f32 at hidden 8 and 2 iterations, from the JAX weights: the
    losses of the TPU probe's ``run`` (its Trainer on its own packed
    batches, plans of tile 256, kernels in interpret mode)."""
    monkeypatch.setattr(doublets, "HIDDEN", 8)
    monkeypatch.setattr(doublets, "N_ITERS", 2)
    got_graphs, want_graphs = doublet_graphs
    per, steps, epochs = 4, 2, 24
    batches = doublets.pack_batches(got_graphs[:per * steps], per)
    stack = stack_batches(batches, "cpu")
    jbatches = jprobe_doublets.pack_batches(want_graphs[:per * steps], per)
    jstack = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x)
                                                 for x in xs]), *jbatches)
    purity = float(stack.y.sum()) / float(stack.edge_mask.sum())
    assert purity == pytest.approx(float(np.asarray(jstack.y).sum())
                                   / float(np.asarray(jstack.edge_mask)
                                           .sum()))
    tcfg = doublets.train_config(epochs, steps, purity)
    tr = doublets.make_trainer("pallas", tcfg, "cpu", compute_dtype=None)
    cfg_j = jm.SegmentClassifierConfig(input_dim=3, hidden_dim=8,
                                       n_iters=2, aggregation="pallas")
    params = _jax_init(tr.model, cfg_j)
    tr_j = _jax_trainer(cfg_j, params, learning_rate=5e-3,
                        lr_schedule="cosine", decay_steps=epochs * steps,
                        pos_weight=max((1 - purity) / purity, 1.0))
    got = tr.run_steps(stack)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tr_j.run_steps(jstack))
    np.testing.assert_allclose(got, want, **FUSED_LOSS_TOL)


def test_doublet_batches_pad_edges_to_eight_and_stack():
    graphs = doublets.build_graphs(1, 40, device="cpu")
    batches = doublets.pack_batches(graphs, 4)
    e_cap = -(-max(g.n_edge for g in graphs) // 8) * 8
    assert batches[0].n_edge == 4 * e_cap
    assert stack_batches(batches).x.shape[0] == len(batches) == \
        len(graphs) // 4


def test_doublet_probe_main_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(doublets, "HIDDEN", 8)
    monkeypatch.setattr(doublets, "N_ITERS", 2)
    rec = doublets.main(["--events-per-step", "1", "--n-steps", "2",
                         "--particles", "40", "--epochs", "2", "--reps",
                         "1", "--device", "cpu", "--no-auc"])
    assert rec["mfu"] is None                   # no card, no MFU
    assert rec["vs_baseline"] > 0 and np.isfinite(rec["final_loss"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-2]) == rec


# ---------------------------------------------------------------------------
# probes.windowcut
# ---------------------------------------------------------------------------

N_EVENTS, BATCH = 256, 16


def test_windowcut_split_equals_the_tpu_probes():
    g = toy2d.make_window_segment_graphs(
        toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0), N_EVENTS)
    got = stack_batches(windowcut.split_epoch(g, N_EVENTS // BATCH))
    jgr = jtoy.make_window_segment_graphs(
        jtoy.Toy2DConfig(n_layers=10, n_tracks=4, seed=0), N_EVENTS)
    steps = N_EVENTS // BATCH
    want = jax.tree.map(
        lambda a: np.stack(np.split(np.asarray(a), steps)), jgr)
    assert got.x.shape[:2] == (steps, BATCH)
    _assert_fields_equal(got, want)


def test_windowcut_epoch_matches_the_jax_trainer():
    """One epoch (a 16-step stack) at the probe's cosine rate, from the
    JAX weights: the JAX Trainer's losses on the TPU probe's split."""
    steps, epochs = N_EVENTS // BATCH, 3
    g = toy2d.make_window_segment_graphs(
        toy2d.Toy2DConfig(n_layers=10, n_tracks=4, seed=0), N_EVENTS)
    stack = stack_batches(windowcut.split_epoch(g, steps))
    tr = windowcut.make_trainer(epochs, steps, "cpu")
    cfg_j = jm.SegmentClassifierConfig(input_dim=3, hidden_dim=32,
                                       n_iters=4)
    params = _jax_init(tr.model, cfg_j)
    tr_j = _jax_trainer(cfg_j, params, learning_rate=3e-3,
                        lr_schedule="cosine", decay_steps=epochs * steps)
    jgr = jtoy.make_window_segment_graphs(
        jtoy.Toy2DConfig(n_layers=10, n_tracks=4, seed=0), N_EVENTS)
    jstack = jax.tree.map(
        lambda a: jnp.asarray(np.stack(np.split(np.asarray(a), steps))), jgr)
    np.testing.assert_allclose(tr.run_steps(stack),
                               np.asarray(tr_j.run_steps(jstack)),
                               **LOSS_TOL)


def test_windowcut_record_has_the_tpu_probes_keys(monkeypatch, capsys):
    """The port's record carries every key of the TPU probe's record (run
    with the same small arguments; below its AUC gate the TPU probe exits
    with its record in the message) and the capture's cost besides."""
    argv = ["--epochs", "2", "--n-events", str(N_EVENTS), "--batch",
            str(BATCH)]

    def record(run):
        try:
            run()
        except SystemExit as gate:      # below the gate: no auc_gate key
            return json.loads(str(gate).split(": ", 1)[1])
        return json.loads([line for line in capsys.readouterr().out
                           .splitlines() if line.startswith("{")][-1])

    monkeypatch.setattr("sys.argv", ["probe_windowcut.py"] + argv)
    want = record(jprobe_windowcut.main)
    capsys.readouterr()
    got = record(lambda: windowcut.main(argv + ["--device", "cpu"]))
    assert set(want) - {"auc_gate"} <= set(got)
    for k in ("calls_per_epoch", "capture_s", "instantiate_s",
              "memory_beyond_inputs_mib", "ms_per_step"):
        assert k in got
    assert got["calls_per_epoch"] == 1 and got["mfu"] is None
    assert got["steps_per_epoch"] == N_EVENTS // BATCH
