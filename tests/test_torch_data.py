"""The port's data layer against the JAX package's, bit for bit.

Every function of ``gnn_fpga_tpu_torch.data`` takes the same events as its
JAX counterpart (a :class:`Table` built from the JAX fixture's DataFrame)
and must give the same arrays, dtypes and row order: the table
operations against pandas, the CSV reader against ``pd.read_csv``, hit
selection, sectors, the doublet cross-join (its plain PyTorch version and
the C++ library against numpy), graph construction, ACTS and muon
ingestion, full-event and candidate graphs, exploration and plotting.
The events are the JAX data tests' own (``tests/test_data.py``,
``tests/test_data_variants.py``, ``tests/test_acts_mu200.py``,
``tests/test_cli.py``)."""

import io
import multiprocessing.dummy

import numpy as np
import pandas as pd
import pytest
import torch

from gnn_fpga_tpu.data import acts as jacts
from gnn_fpga_tpu.data import candidates as jcand
from gnn_fpga_tpu.data import doublets as jdbl
from gnn_fpga_tpu.data import exploration as jexp
from gnn_fpga_tpu.data import full_events as jfull
from gnn_fpga_tpu.data import muon as jmuon
from gnn_fpga_tpu.data import native as jnative
from gnn_fpga_tpu.data import selection as jsel
from gnn_fpga_tpu.data import trackml_io as jio
from gnn_fpga_tpu_torch.data import acts as tacts
from gnn_fpga_tpu_torch.data import candidates as tcand
from gnn_fpga_tpu_torch.data import doublets as tdbl
from gnn_fpga_tpu_torch.data import exploration as texp
from gnn_fpga_tpu_torch.data import full_events as tfull
from gnn_fpga_tpu_torch.data import muon as tmuon
from gnn_fpga_tpu_torch.data import native as tnative
from gnn_fpga_tpu_torch.data import selection as tsel
from gnn_fpga_tpu_torch.data import table as ttab
from gnn_fpga_tpu_torch.data import trackml_io as tio
from gnn_fpga_tpu_torch.ops.cuda import doublets as dop
from test_acts_mu200 import MU200_CUTS, _write_acts_event_files
from test_cli import write_trackml_events
from test_data import ACTS_HITS_FILE, _muon_df, _trackml_event, toy_hits
from test_data_variants import _hits_df

T = ttab.Table


def table(df: pd.DataFrame) -> ttab.Table:
    return T({c: df[c].to_numpy() for c in df})


def assert_same_table(t: ttab.Table, df: pd.DataFrame):
    """Columns, their order and dtypes, and every value bit for bit."""
    assert t.columns == list(df.columns)
    for c in df.columns:
        a, b = t[c], df[c].to_numpy()
        assert a.dtype == b.dtype, c
        if a.dtype == object:
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def assert_same_graph(tg, jg):
    assert (tg is None) == (jg is None)
    if jg is None:
        return
    for f in ("x", "senders", "receivers", "y", "node_mask", "edge_mask",
              "node_y"):
        a, b = getattr(tg, f), getattr(jg, f)
        if b is None:
            assert a is None, f
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture
def no_native(monkeypatch):
    """The port's CPU cross-join without the C++ library: the kernel's
    plain PyTorch version."""
    monkeypatch.setattr(tnative, "available", lambda: False)


def noisy_trackml_events(directory, n_events, n_tracks, n_noise, seed):
    """``write_trackml_events``'s straight barrel tracks with ``n_noise``
    noise hits (particle_id 0) an event, particle ids above 2^53 and a
    low-pt share, written by ``DataFrame.to_csv`` (repr floats)."""
    rng = np.random.default_rng(seed)
    write_trackml_events(directory, n_events=n_events, n_tracks=n_tracks,
                         seed=seed)
    big = 2 ** 53 + 1
    for prefix in jio.find_event_prefixes(str(directory), None):
        hits, parts, truth = (pd.read_csv(f"{prefix}-{p}.csv")
                              for p in ("hits", "particles", "truth"))
        parts["particle_id"] += big
        parts.loc[::4, ["px", "py"]] *= 0.3          # some below 1 GeV
        truth["particle_id"] += big
        vols = np.array([v for v, _ in jsel.BARREL_VLIDS])
        lays = np.array([l for _, l in jsel.BARREL_VLIDS])
        k = rng.integers(0, len(vols), n_noise)
        phi = rng.uniform(-np.pi, np.pi, n_noise)
        r = rng.uniform(30, 1000, n_noise)
        hid = hits.hit_id.max() + 1 + np.arange(n_noise)
        noise = pd.DataFrame({"hit_id": hid, "x": r * np.cos(phi),
                              "y": r * np.sin(phi),
                              "z": rng.uniform(-500, 500, n_noise),
                              "volume_id": vols[k], "layer_id": lays[k]})
        hits = pd.concat([hits, noise], ignore_index=True)
        truth = pd.concat([truth, pd.DataFrame(
            {"hit_id": hid, "particle_id": 0})], ignore_index=True)
        for p, df in (("hits", hits), ("particles", parts),
                      ("truth", truth)):
            df.to_csv(f"{prefix}-{p}.csv", index=False)


# ---------------------------------------------------------------------------
# The table and the CSV reader against pandas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["repr", "%.4f", "%.6e", "%.17g"])
def test_parse_floats_matches_pandas(fmt):
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.uniform(-1100, 1100, 3000),
                        rng.normal(0, 1, 3000) * 10.0 ** rng.integers(
                            -30, 30, 3000),
                        rng.integers(-10 ** 6, 10 ** 6, 500).astype(float)])
    strs = [repr(x) if fmt == "repr" else fmt % x for x in v.tolist()]
    strs += ["1e5", "-0", "+3.5", ".5", "5.", "1E+07", "nan", "-inf",
             "12345678901234567890123", "0.000123456789012345678901"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(strs) + "\n"))["x"]
    got = ttab.parse_floats(strs)
    np.testing.assert_array_equal(got, want.to_numpy())


@pytest.mark.parametrize("gz", [False, True])
def test_read_csv_matches_pandas(tmp_path, gz):
    rng = np.random.default_rng(1)
    n = 500
    df = pd.DataFrame({
        "particle_id": 2 ** 53 + 1 + rng.integers(0, 10 ** 12, n),
        "x": rng.normal(0, 300, n), "n": rng.integers(-5, 5, n),
        "mixed": np.where(rng.random(n) < 0.5, 1.0,
                          rng.normal(0, 1, n)),
        "flag": rng.random(n) < 0.5, "name": [f"h{i}" for i in range(n)]})
    path = tmp_path / ("t.csv.gz" if gz else "t.csv")
    df.to_csv(path, index=False)
    assert_same_table(ttab.read_csv(str(path)), pd.read_csv(path))


@pytest.mark.parametrize("seed", [0, 1])
def test_table_operations_match_pandas(seed):
    rng = np.random.default_rng(seed)
    n = 400
    df = pd.DataFrame({"a": rng.integers(0, 6, n), "b": rng.integers(0, 4, n),
                       "r": rng.integers(0, 5, n).astype(float),
                       "v": np.where(rng.random(n) < 0.3, np.nan,
                                     rng.normal(size=n))})
    t = table(df)
    # stable multi-key sort
    assert_same_table(t.sort(["b", "r"]),
                      df.sort_values(["b", "r"], kind="stable"))
    # first minimum of r by (a, b), groups in sorted order
    np.testing.assert_array_equal(
        t.group_argmin(["a", "b"], "r"),
        df.groupby(["a", "b"]).r.idxmin().to_numpy())
    np.testing.assert_array_equal(
        t.group_nunique(["a"], "b"),
        df.groupby("a")["b"].transform("nunique").to_numpy())
    first = df.groupby("a").first()
    assert_same_table(t.group_first(["a"]).select(["b", "r", "v"]), first)
    np.testing.assert_array_equal(t.group_first(["a"])["a"], first.index)
    assert_same_table(ttab.drop_duplicates(t, ["a", "b"]),
                      df.drop_duplicates(["a", "b"]))
    np.testing.assert_array_equal(ttab.first_appearance(t["a"]),
                                  df.a.drop_duplicates().to_numpy())
    keys = [k for k, _ in ttab.groups(t, ["b", "a"])]
    assert keys == [tuple(k) for k in df.groupby(["b", "a"]).groups]
    # inner join with repeated keys on both sides: the left rows' order
    right = pd.DataFrame({"a": rng.integers(0, 8, 30),
                          "b": rng.integers(0, 4, 30),
                          "w": rng.normal(size=30)})
    for on in (["a"], ["a", "b"]):
        assert_same_table(ttab.inner_join(t, table(right), on=on),
                          df.merge(right, on=on))
    assert_same_table(
        ttab.concat([t, t.take(np.arange(3))]),
        pd.concat([df, df.iloc[:3]], ignore_index=True))


# ---------------------------------------------------------------------------
# TrackML reading, hit selection, sectors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trackml_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("trackml")
    noisy_trackml_events(d, n_events=2, n_tracks=60, n_noise=80, seed=5)
    return d


def test_load_event_matches_jax(trackml_dir):
    prefixes = tio.find_event_prefixes(str(trackml_dir), None)
    assert prefixes == jio.find_event_prefixes(str(trackml_dir), None)
    assert [tio.event_id_from_prefix(p) for p in prefixes] == \
        [jio.event_id_from_prefix(p) for p in prefixes]
    for prefix in prefixes:
        for t, df in zip(tio.load_event(prefix), jio.load_event(prefix)):
            assert_same_table(t, df)
        pid = tio.load_event(prefix)[2]["particle_id"]
        assert pid.dtype == np.int64 and pid.max() > 2 ** 53


@pytest.mark.parametrize("pt_min,no_missing_hits",
                         [(0.0, False), (1.0, False), (1.0, True),
                          (3.0, False)])
def test_select_hits_matches_jax(trackml_dir, pt_min, no_missing_hits):
    prefix = tio.find_event_prefixes(str(trackml_dir), None)[0]
    jh, jp, jt = jio.load_event(prefix)
    th, tp, tt = tio.load_event(prefix)
    assert_same_table(
        tsel.select_hits(th, tt, tp, pt_min, no_missing_hits),
        jsel.select_hits(jh, jt, jp, pt_min, no_missing_hits))


def test_select_hits_dedup_and_barrel_match_jax():
    """The JAX test's duplicate hit (kept: the min-r one) and noise hit off
    the barrel."""
    hits, truth, particles = _trackml_event(n_tracks=3, seed=4)
    dup = hits.iloc[[0, 5]].assign(hit_id=[998, 999],
                                   x=hits.iloc[[0, 5]].x * [2, 0.5])
    hits = pd.concat([hits, dup], ignore_index=True)
    truth = pd.concat([truth, pd.DataFrame(
        {"hit_id": [998, 999], "particle_id": [1, 1]})], ignore_index=True)
    assert_same_table(
        tsel.select_hits(table(hits), table(truth), table(particles)),
        jsel.select_hits(hits, truth, particles))


@pytest.mark.parametrize("n_sectors,select", [(8, False), (3, False),
                                              (8, True)])
def test_split_phi_sectors_match_jax(trackml_dir, n_sectors, select):
    prefix = tio.find_event_prefixes(str(trackml_dir), None)[1]
    jh = jsel.select_hits(*[jio.load_event(prefix)[i] for i in (0, 2, 1)])
    th = tsel.select_hits(*[tio.load_event(prefix)[i] for i in (0, 2, 1)])
    jsec = jsel.split_phi_sectors(jh, n_sectors, select)
    tsec = tsel.split_phi_sectors(th, n_sectors, select)
    assert len(tsec) == len(jsec)
    for t, df in zip(tsec, jsec):
        assert_same_table(t, df)
    assert tsel.hits_summary(th.assign(evtid=np.int64(3))) == \
        jsel.hits_summary(jh.assign(evtid=3))


# ---------------------------------------------------------------------------
# The doublet cross-join
# ---------------------------------------------------------------------------

def _pair_sets(seed, sizes, boundary=False):
    """Hit sets for layer pairs of ``sizes`` ((n1, n2) each, zeros for
    empty pairs); with ``boundary`` some pairs sit exactly on the cuts."""
    rng = np.random.default_rng(seed)
    cols = [[] for _ in range(6)]
    for n1, n2 in sizes:
        r1, r2 = rng.uniform(20, 40, n1), rng.uniform(50, 70, n2)
        p1, p2 = rng.uniform(-np.pi, np.pi, n1), rng.uniform(-np.pi, np.pi, n2)
        z1, z2 = rng.uniform(-200, 200, n1), rng.uniform(-200, 200, n2)
        if boundary and n1 and n2:
            # dr = 32 and dphi = cut * 32 exactly: |slope| == cut, not kept;
            # a hit one ulp inside is
            r2[0], p2[0] = r1[0] + 32.0, p1[0] + 0.015625 * 32.0
            r2[-1], p2[-1] = r1[-1] + 32.0, np.nextafter(
                p1[-1] + 0.015625 * 32.0, p1[-1])
            z2[0], z2[-1] = z1[0], z1[-1]          # z0 = z1
            z1[1] = 150.0
            z2[1] = 150.0                          # z0 == 150 == z0_max
            r2[1] = r1[1] + 10.0
            p2[1] = p1[1]
        for c, v in zip(cols, (r1, p1, z1, r2, p2, z2)):
            c.append(v)
    off = lambda k: np.concatenate(
        [[0], np.cumsum([s[k] for s in sizes])]).astype(np.int64)
    return [np.concatenate(c) for c in cols], off(0), off(1)


def _numpy_pairs(hits, off1, off2, cuts, z0_max):
    """select_segments_arrays pair by pair (numpy), as global rows."""
    out1, out2 = [], []
    for p, cut in enumerate(cuts):
        s1 = slice(off1[p], off1[p + 1])
        s2 = slice(off2[p], off2[p + 1])
        i1, i2 = jdbl.select_segments_arrays(
            *(h[s1] for h in hits[:3]), *(h[s2] for h in hits[3:]), cut,
            z0_max, use_native=False)
        out1.append(i1 + off1[p])
        out2.append(i2 + off2[p])
    return np.concatenate(out1), np.concatenate(out2)


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 22])
@pytest.mark.parametrize("boundary", [False, True])
def test_select_segments_reference_matches_numpy(chunk, boundary):
    """The plain version, pair by pair in chunks of inner rows (7 and 64
    elements split rows mid-pair), with empty pairs and hits on the
    cuts' boundaries."""
    sizes = [(13, 17), (0, 9), (21, 11), (5, 0), (30, 40)]
    hits, off1, off2 = _pair_sets(3, sizes, boundary)
    cuts = np.array([0.015625, 0.02, 1e31, 0.1, 0.015625])
    z0_max = 150.0
    args = [torch.from_numpy(h) for h in hits] + [
        torch.from_numpy(off1), torch.from_numpy(off2),
        torch.from_numpy(cuts)]
    i1, i2 = dop.select_segments_reference(*args, z0_max, chunk_elems=chunk)
    w1, w2 = _numpy_pairs(hits, off1, off2, cuts, z0_max)
    assert i1.dtype == torch.int64 and len(w1) > 0
    np.testing.assert_array_equal(i1.numpy(), w1)
    np.testing.assert_array_equal(i2.numpy(), w2)
    # the CPU wrapper is the plain version
    g1, g2 = dop.select_segments(*args, z0_max)
    np.testing.assert_array_equal(g1.numpy(), w1)
    np.testing.assert_array_equal(g2.numpy(), w2)


@pytest.mark.parametrize("use_native", [False, True])
def test_select_segments_batched_cpu_matches_numpy(use_native, monkeypatch):
    """On the CPU the C++ library pair by pair where it is built, else the
    plain version: both numpy's doublets."""
    if use_native and not tnative.available():
        pytest.skip("native library not built (make -C native)")
    if not use_native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    sizes = [(173, 211), (0, 4), (50, 60)]
    hits, off1, off2 = _pair_sets(7, sizes)
    cuts = [0.02, 0.3, 0.05]
    i1, i2 = tdbl.select_segments_batched(*hits, off1, off2, cuts, 150.0,
                                          device="cpu")
    w1, w2 = _numpy_pairs(hits, off1, off2, cuts, 150.0)
    np.testing.assert_array_equal(i1, w1)
    np.testing.assert_array_equal(i2, w2)


def test_select_segments_batched_refuses_bad_offsets():
    hits, off1, off2 = _pair_sets(1, [(4, 5), (3, 2)])
    for bad1, bad2 in ((off1[:-1], off2), (off1, off2 + 1),
                       (off1[::-1], off2)):
        with pytest.raises(ValueError, match="offsets"):
            tdbl.select_segments_batched(*hits, bad1, bad2, [0.1, 0.1], 1.0,
                                         device="cpu")


def test_native_matches_jax_native():
    if not tnative.available() or not jnative.available():
        pytest.skip("native library not built (make -C native)")
    hits, _, _ = _pair_sets(9, [(64, 80)])
    a = tnative.select_segments_native(*hits, 0.05, 100.0)
    b = jnative.select_segments_native(*hits, 0.05, 100.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tnative.num_threads() >= 1


def test_select_segments_checks_its_arguments():
    hits, off1, off2 = _pair_sets(0, [(3, 4)])
    args = [torch.from_numpy(h) for h in hits] + [
        torch.from_numpy(off1), torch.from_numpy(off2),
        torch.tensor([0.1], dtype=torch.float64)]
    with pytest.raises(ValueError, match="float64"):
        dop.select_segments(*[a.float() if i == 0 else a
                              for i, a in enumerate(args)], 1.0)
    with pytest.raises(ValueError, match="shape"):
        dop.select_segments(*args[:8], torch.zeros(2, dtype=torch.float64),
                            1.0)


def _graph_cases():
    perturbed = toy_hits(n_tracks=6, n_layers=4, seed=9)
    rng = np.random.default_rng(1)
    perturbed["phi"] += rng.normal(0, 0.01, len(perturbed))
    layered = toy_hits(n_tracks=3, n_layers=7)
    layered["phi"] += np.random.default_rng(1).normal(0, 1e-3, len(layered))
    gap = toy_hits(n_tracks=2, n_layers=3)
    return {
        "labels_and_topology": (toy_hits(n_tracks=4, n_layers=4),
                                jdbl.adjacent_layer_pairs(4),
                                dict(phi_slope_max=1e-4, z0_max=1e6), {}),
        "layer_dependent_cut": (layered, jdbl.adjacent_layer_pairs(7),
                                dict(phi_slope_max=1e9,
                                     phi_slope_outer_max=1e-9, z0_max=1e9,
                                     inner_layer_max=5), {}),
        "empty_layer_skipped": (gap[gap.layer != 1], [(0, 1), (1, 2), (0, 2)],
                                {}, {}),
        "no_segments": (toy_hits(n_tracks=2, n_layers=2), [(0, 1)],
                        dict(phi_slope_max=0.0, z0_max=0.0), {}),
        "sorted_with_layers": (perturbed, jdbl.adjacent_layer_pairs(4),
                               dict(phi_slope_max=0.004, z0_max=500.0),
                               dict(sort_by_layer=True, return_layers=True)),
        "perfect_tracks": (pd.concat([perturbed, perturbed.iloc[:2].assign(
            particle_id=99)], ignore_index=True),
            jdbl.adjacent_layer_pairs(4),
            dict(phi_slope_max=0.004, z0_max=500.0),
            dict(no_missing_hits=True, n_det_layers=4)),
    }


@pytest.mark.parametrize("case", list(_graph_cases()))
@pytest.mark.parametrize("native", [True, False])
def test_construct_graph_matches_jax(case, native, monkeypatch):
    hits, pairs, cuts, kw = _graph_cases()[case]
    if not native:
        monkeypatch.setattr(tnative, "available", lambda: False)
    scale = np.array([1000.0, np.pi, 1000.0])
    want = jdbl.construct_graph(hits, pairs, cuts=jdbl.SegmentCuts(**cuts),
                                feature_scale=scale, **kw)
    got = tdbl.construct_graph(table(hits), pairs,
                               cuts=tdbl.SegmentCuts(**cuts),
                               feature_scale=scale, device="cpu", **kw)
    if kw.get("return_layers"):
        (got, got_layers), (want, want_layers) = got, want
        np.testing.assert_array_equal(got_layers, want_layers)
        assert got_layers.dtype == want_layers.dtype
    assert_same_graph(got, want)
    if want is not None:
        assert tdbl.segment_efficiency_purity(got, table(hits), n_true_expected=5) \
            == jdbl.segment_efficiency_purity(want, hits, n_true_expected=5)


def test_construct_graph_max_tracks_picks_the_jax_tracks(no_native):
    """``max_tracks`` draws the labels in order of first appearance with
    the caller's generator.  (The JAX package's own max_tracks path raises
    under pandas 3, whose ``.values`` is read-only: the oracle is its
    construct_graph on the tracks its draw would keep.)"""
    hits = toy_hits(n_tracks=12, n_layers=4, seed=2).sample(
        frac=1.0, random_state=1)
    cuts = dict(phi_slope_max=0.01, z0_max=500.0)
    keys = hits.particle_id.drop_duplicates().to_numpy().copy()
    np.random.default_rng(7).shuffle(keys)
    want = jdbl.construct_graph(hits[hits.particle_id.isin(keys[:5])],
                                jdbl.adjacent_layer_pairs(4),
                                cuts=jdbl.SegmentCuts(**cuts))
    got = tdbl.construct_graph(table(hits), tdbl.adjacent_layer_pairs(4),
                               cuts=tdbl.SegmentCuts(**cuts), max_tracks=5,
                               rng=np.random.default_rng(7), device="cpu")
    assert_same_graph(got, want)


def test_construct_graph_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the GPU-less case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdbl.construct_graph(table(toy_hits()), [(0, 1)])


def test_layer_pairs_and_angles_match_jax():
    np.testing.assert_array_equal(tdbl.adjacent_layer_pairs(10),
                                  jdbl.adjacent_layer_pairs(10))
    for layers in ([1, 3, 8, -2, -5, 3], [2.0], [-1.0, -3.0, 4.0, 6.0]):
        np.testing.assert_array_equal(tdbl.dynamic_layer_pairs(layers),
                                      jdbl.dynamic_layer_pairs(layers))
    rng = np.random.default_rng(0)
    a, b = rng.uniform(-4, 4, 100), rng.uniform(-4, 4, 100)
    np.testing.assert_array_equal(tdbl.calc_dphi(a, b), jdbl.calc_dphi(a, b))
    np.testing.assert_array_equal(tdbl.calc_eta(a + 5, b),
                                  jdbl.calc_eta(a + 5, b))


def test_prepared_sectors_match_jax_graphs(trackml_dir, no_native):
    """Selection, sectors and the CLI's graphs at its default cuts, the
    CPU's plain cross-join against the JAX package's C++ or numpy one."""
    prefix = tio.find_event_prefixes(str(trackml_dir), None)[0]
    jh, jp, jt = jio.load_event(prefix)
    th, tp, tt = tio.load_event(prefix)
    jsec = jsel.split_phi_sectors(jsel.select_hits(jh, jt, jp, 0.0), 4)
    tsec = tsel.split_phi_sectors(tsel.select_hits(th, tt, tp, 0.0), 4)
    cuts = dict(phi_slope_max=0.01, phi_slope_outer_max=0.01, z0_max=200.0)
    n_edges = 0
    for t, df in zip(tsec, jsec):
        want = jdbl.construct_graph(df, jdbl.adjacent_layer_pairs(10),
                                    cuts=jdbl.SegmentCuts(**cuts),
                                    sort_by_layer=True, return_layers=True)
        got = tdbl.construct_graph(t, tdbl.adjacent_layer_pairs(10),
                                   cuts=tdbl.SegmentCuts(**cuts),
                                   sort_by_layer=True, return_layers=True,
                                   device="cpu")
        assert_same_graph(got[0], want[0])
        if want[0] is not None:
            np.testing.assert_array_equal(got[1], want[1])
            n_edges += want[0].n_edge
    assert n_edges > 0


# ---------------------------------------------------------------------------
# ACTS
# ---------------------------------------------------------------------------

def test_acts_literal_lines_match_jax(tmp_path):
    p = tmp_path / "hits.txt"
    p.write_text(ACTS_HITS_FILE)
    jdf = jacts.load_data_events(str(p), jacts.HITS_COLUMNS, start_evtid=3)
    tdf = tacts.load_data_events(str(p), tacts.HITS_COLUMNS, start_evtid=3)
    assert_same_table(tdf, jdf)
    assert_same_table(tacts.process_hits_data(tdf),
                      jacts.process_hits_data(jdf))
    df = pd.DataFrame({"evtid": [0, 0, 0, 0], "barcode": [1, 1, 1, 1],
                       "volid": [8, 13, 17, 7], "layid": [2, 4, 2, 2],
                       "r": [1.0, 2.0, 3.0, 4.0], "phi": [0.0] * 4,
                       "z": [0.0] * 4})
    assert_same_table(tacts.select_barrel_hits(table(df)),
                      jacts.select_barrel_hits(df))
    h = pd.DataFrame({"evtid": [0, 0], "barcode": [1, 2]})
    for p in (pd.DataFrame({"evtid": [0, 0], "barcode": [1, 2]}),
              pd.DataFrame({"evtid": [0], "barcode": [1]})):
        assert tacts.data_consistent(table(h), table(p)) == \
            jacts.data_consistent(h, p)


@pytest.fixture(scope="module")
def acts_files(tmp_path_factory):
    """The mu200 test's ACTS files: 400 particles, two events."""
    return _write_acts_event_files(tmp_path_factory.mktemp("acts"), 400,
                                   seed=7)


def test_acts_mu200_pipeline_matches_jax(acts_files, no_native):
    hits_file, parts_file = acts_files
    with multiprocessing.dummy.Pool(2) as pool:   # any pool's map
        th, tp = tacts.process_files([hits_file, hits_file],
                                     [parts_file, parts_file], pool)
        jh, jp = jacts.process_files([hits_file, hits_file],
                                     [parts_file, parts_file], pool)
    for t, df in zip(th + tp, jh + jp):
        assert_same_table(t, df)
    th, tp = tacts.check_data_consistency(th, tp)
    jh, jp = jacts.check_data_consistency(jh, jp)
    assert len(th) == len(jh) == 2
    tsel_, jsel_ = tacts.select_hits(th[1]), jacts.select_hits(jh[1])
    assert_same_table(tsel_, jsel_)
    ev = 2
    schema = dict(label="barcode")
    scale = np.array([1000.0, np.pi, 1000.0])
    want = jdbl.construct_graph(
        jsel_[jsel_.evtid == ev], jdbl.adjacent_layer_pairs(10),
        cuts=MU200_CUTS, schema=jdbl.ColumnSchema(**schema),
        feature_scale=scale, sort_by_layer=True)
    got = tdbl.construct_graph(
        tsel_.filter(tsel_["evtid"] == ev), tdbl.adjacent_layer_pairs(10),
        cuts=tdbl.SegmentCuts(phi_slope_max=7e-4, phi_slope_outer_max=7e-4,
                              z0_max=500.0),
        schema=tdbl.ColumnSchema(**schema), feature_scale=scale,
        sort_by_layer=True, device="cpu")
    assert_same_graph(got, want)
    assert want.n_edge > 2 * want.n_node
    bins, ranges = [(4, 8, 6)], [((0, 4), (-np.pi, np.pi), (-500, 500))]
    for a, b in zip(tacts.bin_barrel_hits(tsel_, None, [0], bins, ranges),
                    jacts.bin_barrel_hits(jsel_, None, [0], bins, ranges)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Muon endcap
# ---------------------------------------------------------------------------

def _muon_frames():
    sig = _muon_df([0, 1, 3, 4], z_sign=1)
    sig.loc[2, "vh_sim_tp1"] = 1                        # not truth-matched
    sig = pd.concat([sig, sig.iloc[[0]].assign(vh_sim_r=999.0)],
                    ignore_index=True)                 # a duplicate station
    pu = pd.concat([_muon_df([0, 1, 2], z_sign=-1, station_seq=(
        (2, 1, 2), (2, 2, 2), (2, 2, 2), (1, 2, 1))),
        _muon_df([5], z_sign=1, station_seq=((3, 1, 1), (0, 1, 1)))],
        ignore_index=True)
    gen = pd.DataFrame({"vp_pt": [22.5, 3.0, 40.0],
                        "vp_eta": [1.7, 2.0, -1.9]}, index=[0, 1, 3])
    return sig, pu, gen


def test_emtf_lut_and_layers_match_jax():
    np.testing.assert_array_equal(tmuon.EMTF_LUT, jmuon.EMTF_LUT)
    assert tmuon.get_layer(2, 4, 3) == jmuon.get_layer(2, 4, 3) == 12
    sig, pu, _ = _muon_frames()
    assert_same_table(tmuon.assign_layers(table(pu)),
                      jmuon.assign_layers(pu))


@pytest.mark.parametrize("muon_only", [False, True])
def test_muon_pipeline_matches_jax(tmp_path, muon_only, no_native):
    sig, pu, gen = _muon_frames()
    jmix, jmu = jmuon.prepare_hits(sig, pu)
    tmix, tmu = tmuon.prepare_hits(table(sig), table(pu))
    for t, j in ((tmix, jmix), (tmu, jmu)):
        assert list(t) == list(j)
        for k in j:
            assert_same_table(t[k], j[k])
    cfg = dict(muon_only=muon_only)
    want = jmuon.build_graphs(sig, pu, gen, jmuon.MuonPipelineConfig(**cfg))
    got = tmuon.build_graphs(
        table(sig), table(pu), T({"entry": gen.index.to_numpy(),
                                  "vp_pt": gen.vp_pt.to_numpy(),
                                  "vp_eta": gen.vp_eta.to_numpy()}),
        tmuon.MuonPipelineConfig(**cfg), device="cpu")
    assert [(e, x) for e, _, x in got] == [(e, x) for e, _, x in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        assert_same_graph(a, b)
    paths = tmuon.save_graphs(got, str(tmp_path / "t"))
    jpaths = jmuon.save_graphs(want, str(tmp_path / "j"))
    for a, b in zip(paths, jpaths):
        with np.load(a) as fa, np.load(b) as fb:
            assert fa.files == fb.files
            for k in fb.files:
                assert fa[k].dtype == fb[k].dtype
                np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("suffix", ["csv", "parquet"])
def test_load_ntuple_matches_jax(tmp_path, suffix):
    sig, _, _ = _muon_frames()
    path = tmp_path / f"m.{suffix}"
    if suffix == "parquet":
        pytest.importorskip("pyarrow")
        sig.astype({"vh_station": np.int32}).to_parquet(path, index=False)
    else:
        sig.to_csv(path, index=False)
    assert_same_table(tmuon.load_ntuple(str(path), 1, 4),
                      jmuon.load_ntuple(str(path), 1, 4))
    with pytest.raises(ImportError):
        tmuon.load_ntuple(str(tmp_path / "m.root"))


# ---------------------------------------------------------------------------
# Full events, candidates, exploration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2])
def test_full_event_graphs_match_jax(seed):
    hits = pd.concat([_hits_df(n_tracks=6, n_layers=5, n_noise=12,
                               seed=seed),
                      _hits_df(n_tracks=4, n_layers=5, seed=seed + 1).assign(
                          evtid=1)], ignore_index=True)
    kw = dict(dphi_max=0.3, dz_max=200.0, n_nodes_min=None,
              n_nodes_max=None, n_edges_max=None)
    assert_same_graph(
        tfull.construct_graph(table(hits), tfull.FullEventConfig(**kw),
                              device="cpu"),
        jfull.construct_graph(hits, jfull.FullEventConfig(**kw)))
    for occ in (dict(n_nodes_min=20), {}):
        tg = tfull.build_event_graphs(
            table(hits), cfg=tfull.FullEventConfig(**dict(kw, **occ)),
            device="cpu")
        jg = jfull.build_event_graphs(
            hits, cfg=jfull.FullEventConfig(**dict(kw, **occ)))
        assert len(tg) == len(jg)
        for a, b in zip(tg, jg):
            assert_same_graph(a, b)


@pytest.mark.parametrize("float32_hits", [False, True])
def test_candidate_graphs_match_jax(float32_hits):
    """Candidate graphs, with float64 and with ACTS-like float32 hits
    (the track's hit taken as a row of its table's common type)."""
    hits = _hits_df(n_tracks=7, n_layers=4, n_noise=6, seed=1)
    hits = hits[~((hits.barcode == 3) & (hits.layer == 2))]
    if float32_hits:
        hits = hits.astype({"r": np.float32, "phi": np.float32,
                            "z": np.float32, "layer": np.int8})
    cfg = dict(n_det_layers=4, n_layer_hits=3, n_seed_layers=2)
    want = jcand.build_candidate_dataset(hits, jcand.CandidateConfig(**cfg))
    got = tcand.build_candidate_dataset(table(hits),
                                        tcand.CandidateConfig(**cfg))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert_same_graph(a, b)
    s, r = tcand.candidate_edges(4, 3)
    np.testing.assert_array_equal(s, jcand.candidate_edges(4, 3)[0])


def test_exploration_matches_jax():
    rng = np.random.default_rng(5)
    rows = []
    for ev in range(3):
        for pid in range(4):
            n = rng.integers(2, 6)
            r = np.sort(rng.uniform(30, 1000, n))
            phi = (rng.uniform(-np.pi, np.pi) + np.cumsum(
                rng.normal(0, 0.02, n)) + np.pi) % (2 * np.pi) - np.pi
            z = rng.uniform(-200, 200, n)
            rows += [(ev, pid, r[i], phi[i], z[i],
                      float(np.arcsinh(z[i] / r[i]))) for i in range(n)]
    hits = pd.DataFrame(rows, columns=["evtid", "barcode", "r", "phi", "z",
                                       "eta"]).sample(frac=1.0,
                                                      random_state=0)
    parts = pd.DataFrame(
        [(ev, pid, rng.uniform(-np.pi, np.pi), rng.uniform(-2, 2))
         for ev in (2, 0, 1) for pid in range(4)],
        columns=["evtid", "barcode", "phi", "eta"])
    for no_eta in (False, True):
        h = hits.drop(columns="eta") if no_eta else hits
        for k, v in jexp.track_spans(h).items():
            np.testing.assert_array_equal(texp.track_spans(table(h))[k], v)
    for k, v in jexp.multiplicities(hits, parts).items():
        np.testing.assert_array_equal(
            texp.multiplicities(table(hits), table(parts))[k], v)
    want = jexp.hit_particle_deltas(hits, parts)
    got = texp.hit_particle_deltas(table(hits), table(parts))
    for side in want:
        for k in want[side]:
            np.testing.assert_array_equal(got[side][k], want[side][k])
    occ = hits.assign(volid=8, layid=2)
    assert texp.layer_occupancy(table(occ)) == jexp.layer_occupancy(occ)
    np.testing.assert_array_equal(
        texp.calc_dr(hits.eta, parts.eta[:1].item(), hits.phi, 0.5),
        jexp.calc_dr(hits.eta, parts.eta[:1].item(), hits.phi, 0.5))


def test_plotting_writes_files(tmp_path):
    from gnn_fpga_tpu_torch.models import mpnn
    from gnn_fpga_tpu_torch.utils import plotting

    g = tdbl.construct_graph(table(toy_hits(n_tracks=3, n_layers=4)),
                             tdbl.adjacent_layer_pairs(4), device="cpu")
    plotting.draw_sample(g, filename=str(tmp_path / "s.png"))
    plotting.draw_iterations(g, [np.linspace(0, 1, g.n_edge)] * 2,
                             filename=str(tmp_path / "it.png"))
    model = mpnn.init_segment_classifier(
        mpnn.SegmentClassifierConfig(input_dim=3, hidden_dim=4, n_iters=1),
        torch.Generator().manual_seed(0), device="cpu")
    plotting.plot_weight_histograms(model, filename=str(tmp_path / "w.png"))
    plotting.plot_weight_histograms({"edge": {"l1": {"w": np.ones((3, 2))}}},
                                    filename=str(tmp_path / "w2.png"))
    spans = texp.track_spans(T({"evtid": np.zeros(6, int),
                                "barcode": np.repeat([1, 2], 3),
                                "r": np.arange(6.0) + 1, "phi": np.zeros(6),
                                "z": np.ones(6)}))
    plotting.plot_track_spans(spans, filename=str(tmp_path / "t.png"))
    for f in ("s.png", "it.png", "w.png", "w2.png", "t.png"):
        assert (tmp_path / f).stat().st_size > 0
