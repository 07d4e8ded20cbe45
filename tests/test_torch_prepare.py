"""The port's prepare CLIs against the JAX package's: the same raw events
give identical NPZ files, key for key, dtype for dtype, bit for bit; NPZ
files cross both ways between the two packages' train CLIs; and the plot
CLI draws the port's muon graphs.

Raw events: ``write_trackml_events`` of ``tests/test_cli.py`` (repr
floats through ``DataFrame.to_csv``), the same with noise hits and more
tracks, and ``chip_smoke.py``'s synthetic TrackML writer (TrackML's
columns, fixed-point floats) at a small size."""

import glob
import os

import numpy as np
import pytest
import torch

import chip_smoke
from gnn_fpga_tpu.cli import plot_graph as jplot
from gnn_fpga_tpu.cli import prepare_graphs as jprep
from gnn_fpga_tpu.cli import prepare_muon_graphs as jprep_mu
from gnn_fpga_tpu.cli import train as jtrain
from gnn_fpga_tpu_torch.cli import plot_graph as tplot
from gnn_fpga_tpu_torch.cli import prepare_graphs as tprep
from gnn_fpga_tpu_torch.cli import prepare_muon_graphs as tprep_mu
from gnn_fpga_tpu_torch.cli import train as ttrain
from gnn_fpga_tpu_torch.data import native as tnative
from test_cli import write_trackml_events
from test_data import _muon_df
from test_torch_data import noisy_trackml_events

LOOSE = ["--pt-min", "1", "--n-phi-sectors", "1", "--phi-slope-max", "0.1",
         "--phi-slope-outer-max", "0.1", "--z0-max", "1000"]


def assert_same_npz_dirs(dir_a, dir_b) -> int:
    """Same file names, and each file the same arrays by key and dtype."""
    names = sorted(os.path.basename(f)
                   for f in glob.glob(os.path.join(dir_a, "*.npz")))
    assert names == sorted(os.path.basename(f)
                           for f in glob.glob(os.path.join(dir_b, "*.npz")))
    for name in names:
        with np.load(os.path.join(dir_a, name)) as a, \
                np.load(os.path.join(dir_b, name)) as b:
            assert a.files == b.files, name
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
    return len(names)


def _events(kind, d):
    if kind == "cli":
        write_trackml_events(d, n_events=3, n_tracks=6, seed=0)
    elif kind == "noisy":
        noisy_trackml_events(d, n_events=2, n_tracks=80, n_noise=100, seed=3)
    else:
        chip_smoke.write_trackml_events(d, n_events=2, n_particles=600,
                                        seed=1)


@pytest.mark.parametrize("kind,flags", [
    ("cli", LOOSE),
    ("noisy", []),                                  # the CLI's defaults
    ("noisy", ["--pt-min", "0", "--no-missing-hits", "--n-phi-sectors", "2",
               "--phi-slope-max", "0.01", "--phi-slope-outer-max", "0.005"]),
    ("smoke", ["--pt-min", "0.5"]),
    ("smoke", ["--select-phi-sector", "--pt-min", "0"]),
])
@pytest.mark.parametrize("native", [True, False])
def test_prepare_graphs_writes_the_jax_files(tmp_path, kind, flags, native,
                                             monkeypatch):
    if not native:   # the CPU's plain cross-join
        monkeypatch.setattr(tnative, "available", lambda: False)
    raw = tmp_path / "raw"
    raw.mkdir()
    _events(kind, raw)
    common = ["--input-dir", str(raw), "--n-files", "3"] + flags
    want = jprep.main(common + ["--output-dir", str(tmp_path / "jax")])
    got = tprep.main(common + ["--output-dir", str(tmp_path / "port"),
                               "--device", "cpu"])
    assert len(got) == len(want) > 0
    assert assert_same_npz_dirs(tmp_path / "port", tmp_path / "jax") \
        == len(want)
    assert tprep.graphs_summary(got) == jprep.graphs_summary(want)


def test_prepare_graphs_workers_keep_the_order(tmp_path):
    """Two spawned workers load and select, the parent builds: the files
    of one worker, in event order."""
    raw = tmp_path / "raw"
    raw.mkdir()
    write_trackml_events(raw, n_events=3, n_tracks=6, seed=2)
    common = ["--input-dir", str(raw), "--n-files", "3", "--device", "cpu"]
    one = tprep.main(common + LOOSE + ["--output-dir", str(tmp_path / "a")])
    two = tprep.main(common + LOOSE + ["--output-dir", str(tmp_path / "b"),
                                       "--n-workers", "2"])
    assert len(one) == len(two) == 3
    assert_same_npz_dirs(tmp_path / "a", tmp_path / "b")


def test_prepare_graphs_times_each_event(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    write_trackml_events(raw, n_events=2, n_tracks=6, seed=2)
    graphs, times = tprep.run(tprep.parse_args(
        ["--input-dir", str(raw), "--n-files", "2", "--device", "cpu"]
        + LOOSE))
    assert len(graphs) == len(times) == 2
    assert all(t[k] >= 0 for t in times for k in ("read_s", "select_s",
                                                  "build_s"))


def test_prepare_graphs_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this pins the GPU-less case")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep.main(["--input-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprep_mu.main(["--input-muon-dir", str(tmp_path),
                       "--input-pu-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def npz_dirs(tmp_path_factory):
    """The same events prepared by each package."""
    d = tmp_path_factory.mktemp("cross")
    raw = d / "raw"
    raw.mkdir()
    write_trackml_events(raw, n_events=4, n_tracks=6, seed=3)
    common = ["--input-dir", str(raw), "--n-files", "4"] + LOOSE
    jprep.main(common + ["--output-dir", str(d / "jax")])
    tprep.main(common + ["--output-dir", str(d / "port"), "--device", "cpu"])
    return d / "jax", d / "port"


def test_train_clis_load_each_others_files(npz_dirs):
    jax_dir, port_dir = npz_dirs
    jg, jl = jtrain.load_graph_files(str(port_dir), 8)
    tg, tl = ttrain.load_graph_files(str(jax_dir), 8)
    assert len(jg) == len(tg) == 4
    for a, b, la, lb in zip(tg, jg, tl, jl):
        for f in ("x", "senders", "receivers", "y"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
        np.testing.assert_array_equal(la, lb)
    common = ["--n-samples", "4", "--batch-size", "2", "--n-epochs", "1",
              "--hidden-dim", "8", "--n-iters", "2", "--valid-frac", "0",
              "--test-frac", "0", "--prefetch", "0"]
    jt = jtrain.main(["--input-dir", str(port_dir)] + common)
    tt = ttrain.main(["--input-dir", str(jax_dir), "--device", "cpu",
                      "--aggregation", "blocked"] + common)
    assert np.isfinite(jt.train_losses).all()
    assert np.isfinite(tt.train_losses).all()


def _write_muon_files(d, stem, df):
    path = d / f"{stem}.csv"
    df.to_csv(path, index=False)
    return path


def test_prepare_muon_graphs_writes_the_jax_files(tmp_path):
    mu_dir, pu_dir = tmp_path / "mu", tmp_path / "pu"
    mu_dir.mkdir()
    pu_dir.mkdir()
    for k in range(2):
        sig = _muon_df([0, 1, 2, 3], z_sign=1 - 2 * k)
        sig.loc[1, "vh_sim_tp2"] = 1
        rng = np.random.default_rng(k)
        sig = sig.assign(vh_sim_z=sig.vh_sim_z + rng.normal(0, 1, len(sig)),
                         vp_pt=np.repeat(rng.uniform(5, 50, 4), 3),
                         vp_eta=np.repeat(rng.uniform(1.2, 2.4, 4), 3))
        pu = _muon_df([0, 1, 2, 3, 4], z_sign=-1, station_seq=(
            (2, 1, 2), (2, 2, 2), (1, 2, 1), (1, 3, 1)))
        pu = pu.assign(vp_pt=0.0, vp_eta=0.0,
                       vh_sim_phi=rng.uniform(-3, 3, len(pu)))
        _write_muon_files(mu_dir, f"f{k}SingleMuon_Endcap", sig)
        _write_muon_files(pu_dir, f"f{k}SingleNeutrino_PU200", pu)
    for extra in ([], ["--muononly"]):
        common = ["--input-muon-dir", str(mu_dir), "--input-pu-dir",
                  str(pu_dir), "--max-files", "2", "--start", "0",
                  "--end", "4", "--muon-suffix", "SingleMuon_Endcap.csv",
                  "--pu-suffix", "SingleNeutrino_PU200.csv"] + extra
        name = "muononly" if extra else "mixed"
        want = jprep_mu.main(common + ["--output-dir",
                                       str(tmp_path / f"jax_{name}")])
        got = tprep_mu.main(common + ["--output-dir",
                                      str(tmp_path / f"port_{name}"),
                                      "--device", "cpu"])
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want]
        assert assert_same_npz_dirs(tmp_path / f"port_{name}",
                                    tmp_path / f"jax_{name}") == len(want) > 0
    # the plot CLI draws the port's files as the JAX one draws them
    n_port = tplot.main(["--directory", str(tmp_path / "port_mixed"),
                         "--outputname", str(tmp_path / "plots_port"),
                         "--pt-min", "5"])
    n_jax = jplot.main(["--directory", str(tmp_path / "jax_mixed"),
                        "--outputname", str(tmp_path / "plots_jax"),
                        "--pt-min", "5"])
    assert n_port == n_jax > 0
    assert len(glob.glob(str(tmp_path / "plots_port" / "*.png"))) == n_port


def test_prepare_muon_graphs_plots_on_request(tmp_path):
    mu_dir, pu_dir = tmp_path / "mu", tmp_path / "pu"
    mu_dir.mkdir()
    pu_dir.mkdir()
    sig = _muon_df([0, 1]).assign(vp_pt=30.0, vp_eta=1.8)
    pu = _muon_df([0, 1], z_sign=1, station_seq=((2, 1, 2), (2, 2, 2)))
    _write_muon_files(mu_dir, "aSingleMuon_Endcap", sig)
    _write_muon_files(pu_dir, "aSingleNeutrino_PU200", pu.assign(
        vp_pt=0.0, vp_eta=0.0))
    paths = tprep_mu.main([
        "--input-muon-dir", str(mu_dir), "--input-pu-dir", str(pu_dir),
        "--muon-suffix", "SingleMuon_Endcap.csv",
        "--pu-suffix", "SingleNeutrino_PU200.csv", "--plot",
        "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    assert len(paths) == 2
    assert len(glob.glob(str(tmp_path / "out" / "plots" / "*.png"))) == 2
