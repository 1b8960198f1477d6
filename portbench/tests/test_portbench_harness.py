"""The harness on the CPU at tiny size: files found by name, the last
line's shape, the exits without a card or without the program, the import
checks. Run from the repository's root:

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness, noimport
from portbench.tests import tiny_cell

SEED = 2 ** 31 + 12345  # seeds may pass 32 signed bits


@pytest.fixture()
def root(tmp_path):
    return tiny_cell.make_root(tmp_path)


def run(root, cell="tiny", trace=False, seconds=0.5):
    err = io.StringIO()
    rc, line = harness.run(cell, SEED, seconds, trace, device="cpu", root=root, err=err)
    return rc, line, err.getvalue()


def test_added_config_cell_and_metric_are_found_by_name(root):
    """A configuration, a cell and a per-layer metric added as files and
    entries alone reach the line; no harness file changes."""
    pb = root / "portbench"
    cfg = tiny_cell.tiny_config()
    cfg["name"] = "tiny-three-blocks"
    cfg["num_layers"] = 3
    tiny_cell.write(pb / "configs" / "tiny-three-blocks.json", cfg)
    tiny_cell.write(pb / "limits" / "added.json", {"limits": tiny_cell.LIMITS["tiny"]})
    (pb / "metrics" / "calls_seen.video.py").write_text("def read(ctx):\n    return ctx['calls']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "added", "config": "tiny-three-blocks", "traffic": "tiny", "chips": 1,
                               "why": "added as files"})
    bench["configs"].append({"name": "tiny-three-blocks", "source": "https://huggingface.co/Lightricks/LTX-2",
                             "file": "portbench/configs/tiny-three-blocks.json", "reduced": ["num_layers"],
                             "why": "added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "tiny" in m["workloads"]:
            m["workloads"].append("added")
    bench["per_layer"].append({"name": "calls_seen.video", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "video_s",
                               "workloads": ["added"]})
    tiny_cell.write(root / "BENCHMARK.json", bench)
    rc, line, _ = run(root, "added", trace=True)
    assert rc == 0 and line["correct"]
    assert line["metrics"]["calls_seen.video"] == {"value": 1.0, "unit": "calls"}
    rc, line, _ = run(root, "added")
    assert rc == 0 and set(line["metrics"]) == {"video_s", "setup_s"}  # no card: no peak


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", tiny_cell.CELLS)
def test_last_line_shape(root, cell, trace):
    rc, line, err = run(root, cell, trace)
    assert rc == 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"] and keys[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    unit = {"tinydev": "dev", "tinylora": "train"}.get(cell, "video")
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(line, allow_nan=False))  # strict JSON
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        want = {f"{m}.{unit}" for m in ("launches", "elementwise_ms", "idle_share", "mfu")}
        want |= {"video": {"denoise_s.video", "decode_s.video"}, "train": {"step_median_s.train"}}.get(unit, set())
        assert want <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {{"dev": "dev_step_s", "train": "train_step_s"}.get(unit, "video_s"), "setup_s"}
    assert set(line["compared"]) == set(tiny_cell.LIMITS[cell])
    tail = err.strip().splitlines()[-len(tiny_cell.LIMITS[cell]):]
    assert all(t.startswith("compared ") and " limit " in t for t in tail)


def test_k2_roofline_only_where_k2_runs(root):
    """The 4-bit cell's linears run K2's plain version on the CPU: no
    quant_matmul kernel in the trace, so the reader finds nothing."""
    _, line, _ = run(root, "tinyq", trace=True)
    assert "k2_roofline.video" not in line["metrics"]


def test_no_result_without_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "distilled-512x33-x4", "--seed",
                           str(SEED), "--seconds", "1", "--trace", "0"], cwd=tiny_cell.REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_result_without_the_program(tmp_path):
    bare = tmp_path / "bare"
    shutil.copytree(tiny_cell.PB, bare / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny_cell.REPO / "BENCHMARK.json", bare)
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "distilled-512x33-x4", "--seed", "7",
                           "--seconds", "1", "--trace", "1"], cwd=bare, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_import_check_compares_whole_top_level_names():
    mods = {"mlx_video_tpu_torch": 1, "mlx_video_tpu_torch.ops": 1, "jaxtyping": 1, "flaxen": 1}
    assert noimport.loaded(modules=mods) == []
    mods.update({"mlx_video_tpu.ops.quant": 1, "jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1})
    assert noimport.loaded(modules=mods) == ["flax.linen", "jax", "jaxlib.xla_client", "mlx_video_tpu.ops.quant"]


def test_reference_imports_nothing_of_either_package(tmp_path):
    assert noimport.reference_violations(tiny_cell.PB / "reference") == []
    for pkg in ("mlx_video_tpu_torch.ops", "mlx_video_tpu", "jax.numpy"):
        (tmp_path / "planted.py").write_text(f"def f():\n    from {pkg} import x\n")
        assert noimport.reference_violations(tmp_path) == [f"planted.py: {pkg.split('.')[0]}"]


def test_a_run_that_loaded_jax_prints_no_result(root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run(root)
    assert rc != 0 and line is None and "jax" in err


def test_no_run_loads_jax_or_the_jax_package(root):
    """The harness's own modules and a whole tiny run, in a fresh process."""
    code = ("import sys, io; sys.path.insert(0, %r); from portbench import harness, noimport; "
            "rc, line = harness.run('tiny', 5, 0.2, False, device='cpu', root=%r, err=io.StringIO()); "
            "print(rc, line['correct'], noimport.loaded())") % (str(tiny_cell.REPO), str(root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.stdout.split()[-3:] == ["0", "True", "[]"], proc.stderr[-2000:]
