"""The port's instrumentation, the generate CLI's leftover flags, the legacy
dev entry and the file prefetcher, against the JAX package on the CPU.

- utils/profiling.py: ``PhaseTimer`` with ``time.perf_counter`` patched in
  both packages (the same phases, order, report text, JSON file and phase
  events); ``log_memory`` (the CPU line, and the CUDA line from fixed
  allocator numbers against JAX's from the same device statistics);
- utils/debug.py: ``debug_stats`` prints JAX's line on a bf16 array;
- the generate CLI (``--device cpu``, a tiny bundle patched in as
  tests/test_torch_port_cli.py does): ``--profile``, ``--mem-log`` (JAX's
  memory lines at the same stages, the JAX CLI run beside it),
  ``--trace-dir``, ``--metal-capture``, the five noted and six silent
  no-op flags as in JAX, and exactly the nine refused options;
- generate_dev.py: the legacy entry passes its flags through;
- io/prefetch.py: the same bytes as a plain read and as JAX's prefetcher,
  native and under ``MLX_VIDEO_TPU_NO_NATIVE=1``; JAX's ``OSError`` for a
  missing file; a failed build raises; batches and training losses bitwise
  equal with and without the fetcher, through a resume.
"""

import functools
import json
import os
import shutil
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_video_tpu.io import prefetch as jprefetch
from mlx_video_tpu.trainer import datasets as jdata
from mlx_video_tpu.utils import debug as jdebug
from mlx_video_tpu.utils import profiling as jprof
from mlx_video_tpu_torch import generate_dev, loading
from mlx_video_tpu_torch.cli import generate as cli
from mlx_video_tpu_torch.io import prefetch as tprefetch
from mlx_video_tpu_torch.trainer import datasets as tdata
from mlx_video_tpu_torch.trainer import trainer as ttrainer
from mlx_video_tpu_torch.utils import debug as tdebug
from mlx_video_tpu_torch.utils import profiling as tprof
from test_torch_port_cli import _run_main, _tiny_bundle, emb_file  # noqa: F401  (emb_file is a fixture)
from test_torch_port_train import TCFG, _tiny_model, _train_cfg, _write_dataset

# the five options the port refused before its memory plan: all taken now
MEMORY_PLAN = {"low_memory", "aux_stage_int8", "aux_park_device", "no_overlap_staging", "optimize_layouts"}
# each noted flag group and the name its note gives it
NOTED = {"--enable-fp8": ["--enable-fp8"],
         "--stg-scale/--stg-blocks/--stg-mode": ["--stg-scale", "1.5", "--stg-blocks", "3", "--stg-mode", "x"],
         "--eval-interval": ["--eval-interval", "2"],
         "--cache-limit-gb/--memory-limit-gb": ["--cache-limit-gb", "4", "--memory-limit-gb", "8"],
         "--include-reference-in-output": ["--include-reference-in-output"]}
SILENT = [["--cfg-batch"], ["--compile"], ["--no-compile"], ["--compile-shapeless"], ["--fp32-euler"],
          ["--clear-cache"], ["--metal-capture-phase", "stage1"]]


@pytest.fixture
def no_debug_env(monkeypatch):
    """--debug and --verbose set MLX_VIDEO_DEBUG in the process, as in JAX."""
    monkeypatch.delenv("MLX_VIDEO_DEBUG", raising=False)
    monkeypatch.delenv("LTX_DEBUG", raising=False)


# --- utils/profiling.py and utils/debug.py ---

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.75
        return self.t


def _timed_run(mod, monkeypatch, tmp_path):
    clock = _Clock()
    monkeypatch.setattr(mod.time, "perf_counter", clock)
    events = []
    mod.add_event_sink(events.append)
    try:
        timer = mod.PhaseTimer()
        for name in ("stage1_denoise", "upsample", "stage1_denoise", "vae_decode"):
            with timer.phase(name):
                clock()
        path = tmp_path / mod.__name__.split(".")[0] / "phases.json"
        timer.dump_json(path)
    finally:
        mod.remove_event_sink(events.append)
    return timer, path.read_text(), events


def test_phase_timer_matches_jax(monkeypatch, tmp_path, capsys):
    (jt, jjson, jevents), (tt, tjson, tevents) = (_timed_run(m, monkeypatch, tmp_path) for m in (jprof, tprof))
    assert tt.phases == jt.phases == {"stage1_denoise": 3.0, "upsample": 1.5, "vae_decode": 1.5}
    assert list(tt.phases) == list(jt.phases) and tt.total == jt.total
    assert tjson == jjson and tevents == jevents and len(tevents) == 4
    jt.report()
    ref = capsys.readouterr().out
    tt.report()
    assert capsys.readouterr().out == ref and "Phase timing:" in ref


def test_phase_timer_accumulates_when_the_phase_raises(monkeypatch):
    monkeypatch.setattr(tprof.time, "perf_counter", _Clock())
    timer = tprof.PhaseTimer("cpu")
    with pytest.raises(ValueError):
        with timer.phase("stage2_denoise"):
            raise ValueError("x")
    assert timer.phases == {"stage2_denoise": 0.75}


def test_log_memory_cpu_line_matches_jax(capsys):
    jprof.log_memory("stage1 complete")
    ref = capsys.readouterr().err
    tprof.log_memory("stage1 complete", device="cpu")
    assert capsys.readouterr().err == ref == "Memory (stage1 complete): in_use=0.00GB peak=0.00GB limit=0.00GB\n"
    tprof.log_memory("x", enabled=False, device="cpu")
    assert capsys.readouterr().err == ""


def test_log_memory_cuda_line_matches_jax(monkeypatch, capsys):
    """The same bytes read as JAX reads its device statistics and as the
    port reads the CUDA allocator give the same line."""
    in_use, peak, total = 3 * 2**30 + 12345, 7.5 * 2**30, 80 * 10**9

    class Device:
        def memory_stats(self):
            return {"bytes_in_use": in_use, "peak_bytes_in_use": peak, "bytes_limit": total}

    import jax

    monkeypatch.setattr(jax, "local_devices", lambda: [Device()])
    jprof.log_memory("stage2 complete")
    ref = capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: in_use)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: peak)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: type("P", (), {"total_memory": total}))
    tprof.log_memory("stage2 complete", device="cuda")
    assert capsys.readouterr().err == ref == "Memory (stage2 complete): in_use=3.00GB peak=7.50GB limit=74.51GB\n"


@pytest.mark.parametrize("var", ["MLX_VIDEO_DEBUG", "LTX_DEBUG", None])
def test_debug_stats_matches_jax(monkeypatch, capsys, no_debug_env, var):
    if var:
        monkeypatch.setenv(var, "1")
    assert tdebug.debug_enabled() == jdebug.debug_enabled() == bool(var)
    values = (np.random.default_rng(3).normal(size=(2, 5, 7)) * 3 + 1).astype(ml_dtypes.bfloat16)
    jdebug.debug_stats("latents", jnp.asarray(values))
    ref = capsys.readouterr().err
    tdebug.debug_stats("latents", torch.from_numpy(values.view(np.int16).copy()).view(torch.bfloat16))
    assert capsys.readouterr().err == ref
    if var:
        assert ref.startswith("[debug] latents: shape=(2, 5, 7) dtype=bfloat16 min=") and " std=0.0000" not in ref


# --- the generate CLI ---

def _jax_cli_run(tmp_path, emb_file, flags):
    """The JAX CLI on its tiny bundle (tests/test_cli_generate.py)."""
    from test_cli_generate import _run_main as jax_run_main
    from test_cli_generate import _tiny_bundle as jax_tiny_bundle

    jax_run_main(tmp_path, emb_file, jax_tiny_bundle(), flags)


def test_profile_mem_log_and_notes_behave_as_in_jax(monkeypatch, tmp_path, emb_file, capsys, no_debug_env):
    """One run of each CLI with --profile --mem-log --debug, the five noted
    flags and the six silent ones: the same notes, the same memory lines at
    the same stages, MLX_VIDEO_DEBUG set; the port prints its phase report."""
    flags = ["--profile", "--mem-log", "--debug", *[f for group in [*NOTED.values(), *SILENT] for f in group]]
    (tmp_path / "jax").mkdir()
    _jax_cli_run(tmp_path / "jax", emb_file, flags)
    jout = capsys.readouterr()
    monkeypatch.delenv("MLX_VIDEO_DEBUG")
    out = _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), flags)
    tout = capsys.readouterr()
    assert out.stat().st_size > 0

    def notes(text):
        return [line.replace(" on TPU ", " on the GPU ") for line in text.splitlines() if line.startswith("note:")]

    def memory(text):
        return [line for line in text.splitlines() if line.startswith("Memory (")]

    assert notes(tout.out) == notes(jout.out) and len(notes(tout.out)) == 5
    assert memory(tout.err) == memory(jout.err) == [
        f"Memory ({stage} complete): in_use=0.00GB peak=0.00GB limit=0.00GB" for stage in ("stage1", "stage2")]
    report = tout.out[tout.out.index("Phase timing:"):].splitlines()
    assert [line.split()[0] for line in report[1:5]] == ["stage1_denoise", "upsample", "stage2_denoise", "vae_decode"]
    assert report[5].split()[0] == "total"
    assert os.environ["MLX_VIDEO_DEBUG"] == "1"


def test_dev_pipeline_logs_denoise_complete(monkeypatch, tmp_path, emb_file, capsys):
    from test_torch_port_cli import _tiny_dev_bundle

    monkeypatch.setattr(loading, "load_model_bundle", lambda *a, **kw: _tiny_dev_bundle())
    cli.main(["--prompt", "p", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb_file), "--pipeline", "dev",
              "--steps", "2", "--height", "64",
              "--width", "64", "--num-frames", "9", "--latents-only", "--mem-log", "--device", "cpu"])
    err = capsys.readouterr().err
    assert [line for line in err.splitlines() if line.startswith("Memory (")] == [
        "Memory (denoise complete): in_use=0.00GB peak=0.00GB limit=0.00GB"]


def _trace_events(directory):
    files = sorted(directory.glob("trace.*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


@pytest.mark.parametrize("flags", [["--trace-dir", "TMP/traces"], ["--metal-capture-path", "TMP/traces"],
                                   ["--metal-capture"]], ids=["trace_dir", "metal_capture_path", "metal_capture"])
def test_trace_flags_write_a_profiler_trace(monkeypatch, tmp_path, emb_file, flags):
    """A torch.profiler trace of the generation (CPU activity on a CPU run):
    into the given directory, or ./trace with --metal-capture alone."""
    monkeypatch.chdir(tmp_path)
    flags = [f.replace("TMP", str(tmp_path)) for f in flags]
    _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), flags)
    events = _trace_events(tmp_path / ("trace" if flags == ["--metal-capture"] else "traces"))
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_a_traced_run_frees_its_models_when_main_returns(monkeypatch, tmp_path, emb_file):
    """torch.profiler can leave the traced run's frame in a reference cycle
    (on the card after every trace, on the CPU after a process's first):
    main collects it, so an in-process caller gets the bundle back at once,
    with the garbage collector off."""
    import gc
    import weakref

    refs = []

    def load(*args, **kwargs):
        bundle = _tiny_bundle()
        refs.append(weakref.ref(bundle.transformer))
        return bundle

    monkeypatch.setattr(loading, "load_model_bundle", load)
    gc.collect()
    gc.disable()
    try:
        cli.main(["--prompt", "a tiny cat", "--checkpoint-path", str(tmp_path), "--embeddings", str(emb_file),
                  "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1", "--stage2-steps",
                  "1", "--tiling", "none", "--output-path", str(tmp_path / "out.mp4"), "--trace-dir",
                  str(tmp_path / "traces"), "--device", "cpu"])
        assert len(refs) == 1 and refs[0]() is None
    finally:
        gc.enable()


def test_device_trace_without_a_directory_records_nothing(tmp_path):
    with tprof.device_trace(None, "cpu"):
        torch.ones(3).sum()
    with tprof.device_trace(str(tmp_path / "t"), "cpu"):
        torch.ones(3).sum()
    assert any(e.get("name") == "aten::sum" for e in _trace_events(tmp_path / "t"))


def test_refused_set_is_exactly_the_nine_options():
    """The CLI refuses nothing: the memory plan's options are JAX options
    that the port's parser takes, and no refusal table is left."""
    from mlx_video_tpu.cli.generate import build_parser as jax_parser

    assert not hasattr(cli, "_REFUSED") and not hasattr(cli, "unported_flags")
    jax_dests = {a.dest for a in jax_parser()._actions if a.option_strings and a.dest != "help"}
    assert MEMORY_PLAN <= jax_dests and MEMORY_PLAN <= {a.dest for a in cli.build_parser()._actions}


@pytest.mark.parametrize("flags", [["--mesh", "1,1,8"], ["--sequence-parallel", "--mesh", "1,2,1"],
                                   ["--pipeline-parallel", "2"], ["--pipeline-tensor", "2", "--pipeline-parallel", "2"],
                                   ["--low-memory"], ["--aux-stage-int8"],
                                   ["--aux-park-device"], ["--no-overlap-staging"], ["--optimize-layouts"]])
def test_refused_options_exit_naming_what_they_wait_for(monkeypatch, tmp_path, emb_file, flags):
    """The four parallel options, asking for more than one rank with no
    launcher, exit naming torchrun before any weight is loaded. The five
    memory-plan options run: --aux-stage-int8 alone raises the JAX
    function's error (the codec needs --low-memory), the others write the
    video."""
    if flags[0] in ("--mesh", "--sequence-parallel", "--pipeline-parallel", "--pipeline-tensor"):
        with pytest.raises(SystemExit) as info:
            cli.main(["--prompt", "p", "--embeddings", str(emb_file), "--device", "cpu", *flags])
        assert flags[0] in str(info.value) and "torchrun" in str(info.value)
        return
    if flags == ["--aux-stage-int8"]:
        with pytest.raises(ValueError, match="aux_int8_staging is a low_memory transfer codec"):
            _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), flags)
        return
    assert _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), flags).stat().st_size > 0


@pytest.mark.parametrize("flags", [*NOTED.values(), *SILENT], ids=lambda f: f[0])
def test_no_op_flags_print_what_jax_prints(monkeypatch, tmp_path, emb_file, capsys, flags):
    """A noted flag prints its note (JAX's, with the GPU for the TPU) and the
    run goes on; a silent one prints nothing."""
    _run_main(monkeypatch, tmp_path, emb_file, _tiny_bundle(), [*flags, "--latents-only"])
    notes = [line for line in capsys.readouterr().out.splitlines() if line.startswith("note:")]
    named = [name for name, group in NOTED.items() if group == flags]
    assert notes == [f"note: {name} has no effect on the GPU (ignored)" for name in named]


# --- generate_dev.py ---

def test_legacy_dev_entry_passes_its_flags_through(monkeypatch):
    """The JAX entry calls main(["--pipeline", "dev"]) and drops the command
    line (a defect on the reference side); the port passes it on."""
    seen = []
    monkeypatch.setattr(generate_dev, "main", seen.append)
    generate_dev.legacy_main(["--prompt", "a cat", "--steps", "3"])
    monkeypatch.setattr(sys, "argv", ["generate_dev", "--prompt", "b", "--pipeline", "distilled"])
    generate_dev.legacy_main()
    assert seen == [["--pipeline", "dev", "--prompt", "a cat", "--steps", "3"],
                    ["--pipeline", "dev", "--prompt", "b", "--pipeline", "distilled"]]
    assert cli.build_parser().parse_args(seen[1]).pipeline == "distilled"  # a later --pipeline wins


def test_generate_video_dev_picks_the_dev_pipeline(monkeypatch):
    from mlx_video_tpu_torch.pipelines.generate import PipelineType

    calls = []
    monkeypatch.setattr(generate_dev, "generate_video", lambda *a, **kw: calls.append((a, kw)))
    generate_dev.generate_video_dev("models", "text", height=64)
    generate_dev.generate_video_dev("models", "text", pipeline="distilled", tiling="auto")
    assert calls == [(("models", "text"), dict(tiling="none", height=64, pipeline=PipelineType.DEV)),
                     (("models", "text"), dict(tiling="auto", pipeline="distilled"))]


def test_generate_module_reexports_what_jax_reexports():
    import mlx_video_tpu.generate as jgen
    import mlx_video_tpu_torch as tpkg
    import mlx_video_tpu_torch.generate as tgen
    import mlx_video_tpu as jpkg

    names = {n for n in vars(jgen) if not n.startswith("_") and n not in ("annotations",)}
    assert names <= set(vars(tgen))
    assert set(jpkg.__all__) == set(tpkg.__all__) and tpkg.__version__ == jpkg.__version__
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None
    with pytest.raises(AttributeError):
        tpkg.not_a_name  # noqa: B018


# --- io/prefetch.py ---

def _blobs(tmp_path, n=6):
    rng = np.random.default_rng(0)
    files = []
    for i in range(n):
        p = tmp_path / f"blob_{i}.bin"
        p.write_bytes(rng.bytes(1000 * (i + 1) + i))
        files.append(p)
    (tmp_path / "empty.bin").write_bytes(b"")
    return files + [tmp_path / "empty.bin"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "thread_pool"])
def test_prefetcher_reads_the_same_bytes(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("MLX_VIDEO_TPU_NO_NATIVE", "1")
    files = _blobs(tmp_path)
    with tprefetch.FilePrefetcher(num_threads=3) as fetcher, jprefetch.FilePrefetcher(num_threads=3) as ref:
        assert fetcher.is_native == native == tprefetch.native_available()
        for p in files:
            fetcher.submit(p)
            ref.submit(p)
        for p in reversed(files):  # out of order
            assert fetcher.get(p) == ref.get(p) == p.read_bytes()
        assert fetcher.get(files[0]) == files[0].read_bytes()  # a get without a submit


@pytest.mark.parametrize("native", [True, False], ids=["native", "thread_pool"])
def test_prefetcher_raises_oserror_for_a_missing_file(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("MLX_VIDEO_TPU_NO_NATIVE", "1")
    with tprefetch.FilePrefetcher() as fetcher, jprefetch.FilePrefetcher() as ref:
        for f in (fetcher, ref):
            f.submit(tmp_path / "nope.bin")
            with pytest.raises(OSError):
                f.get(tmp_path / "nope.bin")


def test_native_library_is_built_from_the_port_source_and_a_failed_build_raises(tmp_path, monkeypatch):
    lib = tprefetch.build_native()
    assert lib.parent == tprefetch.BUILD_DIR and lib.name.startswith("libmvt_prefetch_") and lib.is_file()
    assert tprefetch.NATIVE_SRC.parent.parent.name == "mlx_video_tpu_torch"
    monkeypatch.setattr(tprefetch, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tprefetch, "library_path", lambda: tmp_path / "libmvt_prefetch_test.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed with exit code"):
        tprefetch.build_native()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(OSError):
        tprefetch.build_native()
    assert list(tmp_path.iterdir()) == []  # no temporary file is left


def test_reader_hints_readahead(tmp_path, monkeypatch):
    from mlx_video_tpu_torch.io import safetensors as tst

    advised = []
    monkeypatch.setattr(tst, "advise_willneed", advised.append)
    tst.save_safetensors(tmp_path / "a.safetensors", {"x": torch.ones(2)})
    with tst.SafetensorsReader(tmp_path / "a.safetensors") as r:
        assert torch.equal(r.get("x"), torch.ones(2))
    assert advised == [tmp_path / "a.safetensors"]
    tprefetch.advise_willneed(tmp_path / "a.safetensors")  # the native call on a real file
    tprefetch.advise_willneed(tmp_path / "missing.safetensors")  # a missing file is no error


@pytest.mark.parametrize("skip", [0, 1])
def test_prefetched_batches_are_the_synchronous_ones(tmp_path, skip):
    """Batches with the fetcher equal the synchronous ones and JAX's, bit for
    bit; a skipped batch's files are never read."""
    _write_dataset(tmp_path / "data", n=5)
    ds = tdata.PrecomputedDataset(tmp_path / "data")
    jds = jdata.PrecomputedDataset(tmp_path / "data")
    sync = list(tdata.iter_batches(ds, batch_size=2, shuffle=True, seed=3, prefetch=0, skip=skip))
    read = []
    original = ds.sample_paths

    def paths(index):
        read.append(index)
        return original(index)

    ds.sample_paths = paths
    pre = list(tdata.iter_batches(ds, batch_size=2, shuffle=True, seed=3, prefetch=2, skip=skip))
    ref = list(jdata.iter_batches(jds, batch_size=2, shuffle=True, seed=3, prefetch=2, skip=skip))
    assert len(sync) == len(pre) == len(ref) == 3 - skip
    for a, b, c in zip(sync, pre, ref):
        for part in ("latents", "conditions"):
            for k in getattr(a, part):
                x, y, z = getattr(a, part)[k], getattr(b, part)[k], np.asarray(getattr(c, part)[k])
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes() == z.astype(x.dtype).tobytes(), k
    groups = tdata._batch_index_groups(ds, 2, True, 3)
    assert set(read) == {i for chunk in groups[skip:] for i in chunk}
    assert ds._fetcher is None


def test_training_losses_are_bitwise_equal_with_and_without_the_fetcher(tmp_path, monkeypatch):
    """Four LoRA steps with the fetcher (the trainer's default), four
    without, and a resume from step 2 with it: the same losses, bit for
    bit."""
    _write_dataset(tmp_path / "data")
    with torch.enable_grad():
        runs = {}
        for name, prefetch in (("pre", 2), ("sync", 0)):
            monkeypatch.setattr(ttrainer, "iter_batches", functools.partial(tdata.iter_batches, prefetch=prefetch))
            trainer = ttrainer.Trainer(_train_cfg(tmp_path / name), model_config=TCFG, params=_tiny_model())
            trainer.train()
            runs[name] = list(trainer.loss_history)
        monkeypatch.setattr(ttrainer, "iter_batches", tdata.iter_batches)
        (tmp_path / "resumed").mkdir()
        shutil.copy(tmp_path / "pre" / "state_step_2.safetensors", tmp_path / "resumed")
        resumed = ttrainer.Trainer(_train_cfg(tmp_path / "resumed", resume=True), model_config=TCFG,
                                   params=_tiny_model())
        resumed.train()
    assert len(runs["pre"]) == 4 and np.isfinite(runs["pre"]).all()
    assert np.array(runs["pre"]).tobytes() == np.array(runs["sync"]).tobytes()
    assert np.array(list(resumed.loss_history)).tobytes() == np.array(runs["pre"][2:]).tobytes()
