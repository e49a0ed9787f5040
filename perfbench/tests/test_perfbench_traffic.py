"""A traffic file names its command's inputs and its check: the command
line built from it, inputs made from the seed and kept for it, a check
found by its name, and a whole cell made of new files only (``quantify``
of the planted loops, checked on its coordinates) run through the
harness on the CPU."""

import json
import types

import numpy as np
import pytest

from perfbench import check, harness

from conftest import run_small, small_cell

LOOP_PAIRS = '''
SUFFIX = ".bed2d"


def make(genome, seed, path):
    b = genome.binsize
    lines = ["chrom1\\tstart1\\tend1\\tchrom2\\tstart2\\tend2"]
    lines += [f"{c}\\t{i * b}\\t{(i + 1) * b}\\t{c}\\t{j * b}\\t{(j + 1) * b}"
              for c, i, j in genome.loops]
    path.write_text("\\n".join(lines) + "\\n")
'''

COORDS_CHECK = '''
import numpy as np

KEY = ("chrom1", "start1", "chrom2", "start2")
VALUES = ()


def reference(genome, traffic, inputs, dtype, device, work, map_dtype):
    rows = [line.split("\\t") for line in inputs["pairs"].read_text().splitlines()[1:]]
    cols = list(zip(*rows))
    table = {"chrom1": np.array(cols[0]), "start1": np.array(cols[1], dtype=np.int64),
             "chrom2": np.array(cols[3]), "start2": np.array(cols[4], dtype=np.int64)}
    return table, None
'''

QUANTIFY = {
    "why": "quantify of the planted loops",
    "argv": ["quantify", "--pattern", "loops", "--no-plotting", "{pairs}", "{map}", "{prefix}"],
    "pattern": "loops",
    "inter": False,
    "inputs": {"pairs": "loop-pairs"},
    "check": "coords",
}


@pytest.fixture
def new_files(tmp_path, monkeypatch):
    """A benchmark folder in ``tmp_path`` that the loaders read: the cell
    ``hg38-5kb-quantify`` of the configuration ``hg38-5kb`` and the
    traffic ``quantify-loops`` with its input maker and its check, as
    files of their own; (folder, a writer of more files)."""
    folder = tmp_path / "bench"

    def write(rel, text):
        path = folder / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text if isinstance(text, str) else json.dumps(text))

    write("cells/hg38-5kb-quantify.json", {
        "config": "hg38-5kb", "traffic": "quantify-loops", "chips": 1,
        "command_metric": "quantify_cmd_s", "limits": {"unmatched_rows": 0}})
    write("traffic/quantify-loops.json", QUANTIFY)
    write("inputs/loop-pairs.py", LOOP_PAIRS)
    write("checks/coords.py", COORDS_CHECK)
    monkeypatch.setattr(harness, "HERE", folder)
    return folder, write


@pytest.mark.parametrize("name", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_detect_cells_keep_their_command_line(name, tmpdir_env):
    cell = harness.load_cell(name)
    assert cell["makers"] == {} and cell["checker"] is check
    command = harness.Command(cell, "genome.mcool::/resolutions/5000", {}, "cpu")
    assert command.argv == [*cell["traffic_data"]["argv"], "genome.mcool::/resolutions/5000",
                            command.prefix]


def test_placeholders_name_the_map_the_prefix_and_the_inputs(new_files):
    cell = harness.load_cell("hg38-5kb-quantify")
    argv = harness.command_argv(cell, "m.mcool::/r/5000", "/o/out", {"pairs": "/c/p.bed2d"})
    assert argv == ["quantify", "--pattern", "loops", "--no-plotting", "/c/p.bed2d",
                    "m.mcool::/r/5000", "/o/out"]
    assert set(cell["makers"]) == {"pairs"} and cell["checker"].KEY[0] == "chrom1"


@pytest.mark.parametrize("fault, missing", [
    ({"argv": ["quantify", "{pairs}", "{bed}", "{map}", "{prefix}"]}, "{bed}"),
    ({"inputs": {"pairs": "no-such-maker"}}, "inputs/no-such-maker.py"),
    ({"check": "no-such-check"}, "checks/no-such-check.py"),
])
def test_an_unknown_name_raises_naming_the_traffic_and_what_is_missing(new_files, fault,
                                                                        missing):
    folder, write = new_files
    write("traffic/quantify-loops.json", {**QUANTIFY, **fault})
    with pytest.raises((FileNotFoundError, ValueError)) as err:
        harness.load_cell("hg38-5kb-quantify")
    assert missing in str(err.value)
    assert str(folder / "traffic" / "quantify-loops.json") in str(err.value)


def test_inputs_are_kept_for_their_seed_and_remade_for_another(tmp_path):
    made = []

    def make(genome, seed, path):
        made.append(seed)
        path.write_text(str(seed))

    maker = types.SimpleNamespace(SUFFIX=".txt", make=make)
    path, seconds = harness.ensure_input(None, tmp_path, 5, "pairs", maker)
    assert path == tmp_path / "pairs-5.txt" and path.read_text() == "5" and seconds >= 0
    (tmp_path / "pairs-extra-5.txt").write_text("another input's")
    assert harness.ensure_input(None, tmp_path, 5, "pairs", maker) == (path, None)
    path6, _ = harness.ensure_input(None, tmp_path, 6, "pairs", maker)
    assert made == [5, 6] and not path.exists() and path6.read_text() == "6"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["pairs-6.txt", "pairs-extra-5.txt"]


def test_a_cell_of_new_files_runs_quantify_to_a_correct_line(new_files, tmpdir_env):
    cell = small_cell("hg38-5kb-quantify")
    rc, result = run_small(cell, tmpdir_env)
    assert rc == 0 and result["correct"], result
    assert result["checks"] == {"unmatched_rows": {"value": 0.0, "limit": 0}}
    assert set(result["metrics"]) == {"setup_s", "peak_device_gib"}
    table, windows = harness.read_outputs(str(tmpdir_env / "perfbench-hg38-5kb-quantify" / "out"))
    pairs = (tmpdir_env / "cache" / "pairs-5.bed2d").read_text().splitlines()[1:]
    assert len(table["chrom1"]) == len(windows) == len(set(pairs)) > 5
    assert table["bin1"].dtype == np.int64 and not np.isnan(table["score"]).all()


def test_compare_matches_rows_on_the_checks_key():
    def table(starts):
        n = len(starts)
        return {"chrom1": np.array(["chr1"] * n), "start1": np.array(starts),
                "chrom2": np.array(["chr1"] * n), "start2": np.array(starts) + 50_000}

    ref = table([5_000, 10_000, 15_000])
    key = ("chrom1", "start1", "chrom2", "start2")
    assert check.compare(table([15_000, 5_000, 10_000]), None, ref, None, key, ()) == {
        "unmatched_rows": 0.0}
    assert check.compare(table([5_000, 10_000, 20_000]), None, ref, None, key, ()) == {
        "unmatched_rows": 2.0}
    assert check.compare(table([5_000, 10_000]), None, ref, None, key, ()) == {
        "unmatched_rows": 1.0}


def test_a_missing_integer_reads_as_nan_and_detect_tables_as_int64(tmp_path):
    from chromosight_torch.io.writers import save_windows, write_patterns

    prefix = str(tmp_path / "out")
    quantify = {"chrom1": np.array(["chr1", "chr2"]), "start1": np.array([5_000, 10_000]),
                "bin1": np.array([np.nan, 3.0]), "bin2": np.array([7, 9]),
                "score": np.array([np.nan, 0.5])}
    write_patterns(quantify, prefix)
    save_windows(np.zeros((2, 3, 3)), prefix)
    table, windows = harness.read_outputs(prefix)
    assert table["bin1"].dtype == np.float64
    assert np.isnan(table["bin1"][0]) and table["bin1"][1] == 3.0
    assert table["bin2"].dtype == np.int64 and table["start1"].dtype == np.int64
    assert windows.shape == (2, 3, 3)
    detect = {**quantify, "bin1": np.array([2, 3]), "kernel_id": np.array([0, 0])}
    write_patterns(detect, prefix)
    table, _ = harness.read_outputs(prefix)
    assert all(table[k].dtype == np.int64 for k in ("start1", "bin1", "bin2", "kernel_id"))
    assert table["bin1"].tolist() == [2, 3] and table["chrom1"].tolist() == ["chr1", "chr2"]
