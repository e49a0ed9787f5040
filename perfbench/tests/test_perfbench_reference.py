"""The reference against the port's CPU path on a few-thousand-bin genome
(loops, borders, --inter through the tiled engine), the lower-precision
control failing, and faults planted in the timed path failing the check.
Every run goes through the harness (set-up, window, check) without its
look for a card."""

import numpy as np
import pytest

from perfbench import check, harness
from perfbench.calibrate import FAULTS
from perfbench.genome import make_genome

from conftest import run_small, small_cell

CELLS = ["hg38-5kb-loops", "hg38-5kb-borders"]
INTER_CHROMS = [["chr1", 4_000_000], ["chr2", 3_000_000], ["chr3", 2_500_000]]


def inter_cell():
    # the cell's own trans law: sparse uniform contacts and the planted
    # trans foci, which give the trans calls that the comparison holds
    return small_cell("hg38-trans3-inter", INTER_CHROMS)


@pytest.fixture
def tiled(monkeypatch):
    """Trans maps above 50 bins a side take the tiled engine, as the
    cell's 39,660-49,792-bin maps do above 8,192."""
    import chromosight_torch.runtime.contact_map as cm

    monkeypatch.setattr(cm, "DENSE_LIMIT", 50)


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name, tmpdir_env):
    rc, result = run_small(small_cell(name), tmpdir_env)
    assert rc == 0
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert result["checks"]["unmatched_rows"]["value"] == 0


def test_inter_port_matches_reference(tiled, tmpdir_env):
    cell = inter_cell()
    rc, result = run_small(cell, tmpdir_env)
    assert rc == 0 and result["correct"], result["checks"]
    table, _ = harness.read_outputs(str(tmpdir_env / f"perfbench-{cell['name']}" / "out"))
    trans = table["chrom1"] != table["chrom2"]
    assert trans.sum() >= 3 * 3  # every pair's foci called, and compared


@pytest.mark.parametrize("name", CELLS + ["hg38-trans3-inter"])
def test_lower_precision_control_fails(name, tiled):
    cell = inter_cell() if name == "hg38-trans3-inter" else small_cell(name)
    genome = make_genome(cell["config_data"], 5, "cpu")
    ref, ref_w = check.reference_of(cell, genome, "cpu")
    ctl, ctl_w = check.reference_of(cell, genome, "cpu", control=True)
    for col in ("score", "pvalue", "qvalue"):
        ctl[col] = np.round(ctl[col], 10)
    numbers = check.compare(ctl, ctl_w, ref, ref_w)
    limits = cell["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_answer_altered_where_produced_fails(monkeypatch, tmpdir_env):
    """The band kernel's scores off by one part in 10^4."""
    import chromosight_torch.detection as det

    monkeypatch.setattr(det, "band_pearson", FAULTS["band-scores"][2](det.band_pearson))
    rc, result = run_small(small_cell("hg38-5kb-loops"), tmpdir_env)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["score_gap"]["value"] > result["checks"]["score_gap"]["limit"]


def test_half_the_maps_left_out_fails(monkeypatch, tmpdir_env):
    from chromosight_torch.runtime.genome import HicGenome

    real = HicGenome.make_sub_matrices

    def half(self):
        real(self)
        self.sub_mats = self.sub_mats.iloc[::2].reset_index(drop=True)

    monkeypatch.setattr(HicGenome, "make_sub_matrices", half)
    rc, result = run_small(small_cell("hg38-5kb-borders"), tmpdir_env)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["unmatched_rows"]["value"] > 0


def test_window_altered_fails(monkeypatch, tmpdir_env):
    import chromosight_torch.cli.main as cli

    real = cli.save_windows

    def shifted(windows, prefix, fmt="json"):
        windows = windows.copy()
        windows[len(windows) // 2] = np.roll(windows[len(windows) // 2], 1, axis=1)
        real(windows, prefix, fmt)

    monkeypatch.setattr(cli, "save_windows", shifted)
    rc, result = run_small(small_cell("hg38-5kb-loops"), tmpdir_env)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["window_gap"]["value"] > result["checks"]["window_gap"]["limit"]


def test_tile_scan_altered_fails(monkeypatch, tiled, tmpdir_env):
    """The tiled engine's scores off by one part in 10^4: the trans calls'
    scores fail the check."""
    import chromosight_torch.detection as det

    monkeypatch.setattr(det, "normxcorr2_sparse_tiled",
                        FAULTS["tile-scores"][2](det.normxcorr2_sparse_tiled))
    rc, result = run_small(inter_cell(), tmpdir_env)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["score_gap"]["value"] > result["checks"]["score_gap"]["limit"]


def test_traced_run_reports_per_layer_metrics(tmpdir_env):
    rc, result = run_small(small_cell("hg38-5kb-loops", [["chr1", 9_000_000]]), tmpdir_env,
                           trace=1)
    assert rc == 0 and result["correct"]
    assert "io_fetch_s.genome" in result["metrics"]
    assert "genome_cmd_s" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0
    assert list(result)[-1] == "checks"
