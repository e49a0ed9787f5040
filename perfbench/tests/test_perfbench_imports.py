"""Nothing a benchmark run loads is JAX or the JAX package: a whole run of
a cell (set-up, window, check) in a fresh process on the CPU, then its
``sys.modules`` by whole top-level name; and the harness's own check
refuses a run where such a module is loaded."""

import json
import pathlib
import subprocess
import sys
import textwrap

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]

SCRIPT = textwrap.dedent("""
    import json, pathlib, sys, tempfile
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    from conftest import run_small, small_cell
    tmp = pathlib.Path(tempfile.mkdtemp(dir={tmp!r}))
    tempfile.tempdir = str(tmp)
    rc, result = run_small(small_cell("hg38-5kb-loops", [["chr1", 9_000_000]]), tmp, trace=1)
    import perfbench.calibrate  # noqa: F401 (loaded by calibration runs)
    from perfbench import harness
    for path in sorted((harness.HERE / "metrics").glob("*.py")):
        harness.load_metric(path.stem)
    tops = sorted({{m.split(".")[0] for m in sys.modules}})
    print(json.dumps({{"rc": rc, "correct": result["correct"], "modules": tops}}))
""")


def test_a_run_loads_no_jax(tmp_path):
    script = SCRIPT.format(root=str(ROOT), tests=str(ROOT / "perfbench" / "tests"),
                           tmp=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=900, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["correct"]
    assert "chromosight_torch" in out["modules"] and "torch" in out["modules"]
    # whole top-level names: chromosight_torch begins with "chromosight"
    # but is not chromosight_tpu
    assert not set(out["modules"]) & set(harness.FORBIDDEN), out["modules"]


def test_the_check_finds_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    monkeypatch.setitem(sys.modules, "chromosight_tpu_like.x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "chromosight_tpu.ops", sys)
    assert harness.forbidden_modules() == ["chromosight_tpu"]


def test_a_module_loaded_after_the_window_refuses_the_run(monkeypatch, tmpdir_env):
    """A reader (or the reference) that loads the JAX package once the
    window has closed: the run prints no result and exits non-zero."""
    from conftest import run_small, small_cell

    real = harness.load_metric

    def loads_jax(name):
        monkeypatch.setitem(sys.modules, "chromosight_tpu", sys)
        return real(name)

    monkeypatch.setattr(harness, "load_metric", loads_jax)
    rc, result = run_small(small_cell("hg38-5kb-loops", [["chr1", 9_000_000]]), tmpdir_env,
                           trace=1)
    assert rc != 0 and result is None
