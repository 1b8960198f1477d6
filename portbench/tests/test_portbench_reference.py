"""The comparison that decides ``correct``, at tiny size on the CPU: the
port against the plain reference passes its limits, the float8 control put
in the program's place fails them, and a whole run with the timed path
broken underneath comes out not correct, once for each fault a distilled
cell can have: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced. One test runs on the
card only (marked ``cuda``)."""

from __future__ import annotations

import io
import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.drivers import dev_slices, distilled, lora_train
from portbench.tests import tiny_cell

SEEDS = (3, 2 ** 31 + 17, 40_000_000_019)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_within_limits_and_control_beyond(seed, quant):
    cfg, traffic = tiny_cell.tiny_config(quant), tiny_cell.tiny_traffic()
    state = distilled.setup(cfg, traffic, seed, "cpu")
    record = distilled.call(state, 0)
    distilled.release(state)
    ref = distilled.reference(state, record["seeds"])
    program = distilled.compare(record, ref)
    low = distilled.reference(state, record["seeds"], lowp=True)
    control = distilled.compare({k: v.numpy() for k, v in low.items()}, ref)
    assert all(program[k] <= limit for k, limit in tiny_cell.DISTILLED.items()), program
    assert any(control[k] > limit for k, limit in tiny_cell.DISTILLED.items()), control


@pytest.mark.parametrize("seed", SEEDS)
def test_dev_slices_within_limits_and_control_beyond(seed):
    cfg, traffic = tiny_cell.tiny_config(), tiny_cell.tiny_dev_traffic()
    state = dev_slices.setup(cfg, traffic, seed, "cpu")
    records = [dev_slices.call(state, i) for i in range(traffic["calibrate_calls"])]
    dev_slices.release(state)
    limits = tiny_cell.LIMITS["tinydev"]
    for pick in range(len(records)):
        program = dev_slices.numbers(state, records, [pick])
        control = dev_slices.control(state, records, [pick])
        assert all(program[k] <= limit for k, limit in limits.items()), program
        assert any(control[k] > limit for k, limit in limits.items()), control


@pytest.mark.parametrize("seed", SEEDS)
def test_lora_steps_within_limits_and_control_beyond(seed):
    cfg, traffic = tiny_cell.tiny_config(), dict(tiny_cell.tiny_lora_traffic(), window_s=0.2)
    state = lora_train.setup(cfg, traffic, seed, "cpu")
    lora_train.call(state, 0)
    lora_train.release(state)
    limits = tiny_cell.LIMITS["tinylora"]
    program = lora_train.judge(state, [], seed)
    control = lora_train.control(state, [], [])
    assert all(program[k] <= limit for k, limit in limits.items()), program
    assert any(control[k] > limit for k, limit in limits.items()), control


def run_broken(tmp_path, monkeypatch, target, wrap, cell="tiny"):
    """A whole run with ``target`` (module, name) of the program replaced by
    ``wrap(original)``."""
    root = tiny_cell.make_root(tmp_path)
    module, name = target
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    rc, line = harness.run(cell, 11, 0.3, False, device="cpu", root=root, err=io.StringIO())
    assert rc == 0
    return line


@pytest.mark.parametrize("cell", ["tiny", "tinydev"])
def test_fault_a_step_returns_its_state_unchanged(tmp_path, monkeypatch, cell):
    """The first step of every denoise call leaves the latents as they
    were."""
    from mlx_video_tpu_torch.pipelines import denoise

    step_of_call = [0]

    def count(orig):
        def run(*args, **kw):
            step_of_call[0] = 0
            return orig(*args, **kw)
        return run

    def wrap(orig):
        def step(latents, denoised, sigma, sigma_next):
            step_of_call[0] += 1
            return latents if step_of_call[0] == 1 else orig(latents, denoised, sigma, sigma_next)
        return step

    monkeypatch.setattr(denoise, "denoise", count(denoise.denoise))
    line = run_broken(tmp_path, monkeypatch, (denoise, "_euler_step"), wrap, cell)
    assert step_of_call[0] and line["correct"] is False


def _generate_wrapper(change):
    def wrap(orig):
        def generate(*args, **kw):
            res = orig(*args, **kw)
            change(res)
            return res
        return generate
    return wrap


def test_fault_half_of_the_batch_left_out(tmp_path, monkeypatch):
    """The second half of the videos are copies of the first half's."""
    from mlx_video_tpu_torch.pipelines import generate

    def change(res):
        n = res.latents.shape[0] // 2
        res.latents[n:] = res.latents[:n]
        res.video[n:] = res.video[:n]

    line = run_broken(tmp_path, monkeypatch, (generate, "generate_video"), _generate_wrapper(change))
    assert line["correct"] is False


@pytest.mark.parametrize("what", ["latents", "video"])
def test_fault_an_answer_altered_where_it_is_produced(tmp_path, monkeypatch, what):
    """One video's output moved by a tenth of its own spread."""
    from mlx_video_tpu_torch.pipelines import generate

    def change(res):
        out = getattr(res, what)
        out[-1] += 0.1 * np.std(out[-1])

    line = run_broken(tmp_path, monkeypatch, (generate, "generate_video"), _generate_wrapper(change))
    assert line["correct"] is False


def test_fault_a_slice_altered_where_it_is_produced(tmp_path, monkeypatch):
    """The dev slice's latents moved by a tenth of their spread as the
    denoise returns them."""
    from mlx_video_tpu_torch.pipelines import denoise

    def wrap(orig):
        def run(*args, **kw):
            latents, audio = orig(*args, **kw)
            return latents + 0.1 * latents.float().std().to(latents.dtype), audio
        return run

    line = run_broken(tmp_path, monkeypatch, (denoise, "denoise"), wrap, "tinydev")
    assert line["correct"] is False


def test_fault_the_encoded_image_altered(tmp_path, monkeypatch):
    from mlx_video_tpu_torch.models.ltx.video_vae import encoder

    def wrap(orig):
        def run(*args, **kw):
            out = orig(*args, **kw)
            return out + 0.1 * out.float().std().to(out.dtype)
        return run

    line = run_broken(tmp_path, monkeypatch, (encoder, "video_encoder_apply"), wrap, "tinydev")
    assert line["correct"] is False


def test_fault_a_training_step_leaves_its_state_unchanged(tmp_path, monkeypatch):
    """The update skipped: the factors never move (the change reads 1)."""
    from mlx_video_tpu_torch.trainer import trainer

    line = run_broken(tmp_path, monkeypatch, (trainer, "apply_updates"), lambda orig: (lambda *a, **k: None),
                      "tinylora")
    assert line["correct"] is False


def test_fault_half_of_the_batch_left_out_of_the_loss(tmp_path, monkeypatch):
    """The masked mean taken over the first half of the tokens alone."""
    from mlx_video_tpu_torch.trainer import strategies

    def wrap(orig):
        def half(pred, targets, mask):
            n = mask.shape[1] // 2
            return orig(pred[:, :n], targets[:, :n], mask[:, :n])
        return half

    line = run_broken(tmp_path, monkeypatch, (strategies, "_masked_mean_sq"), wrap, "tinylora")
    assert line["correct"] is False


def test_fault_the_loss_altered_where_it_is_produced(tmp_path, monkeypatch):
    from mlx_video_tpu_torch.trainer import trainer

    def wrap(orig):
        def step(*args, **kw):
            loss, grads = orig(*args, **kw)
            return loss * 1.01, grads
        return step

    line = run_broken(tmp_path, monkeypatch, (trainer, "grad_step"), wrap, "tinylora")
    assert line["correct"] is False


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell on the card: correct, the end-to-end
    metrics, the device named."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "distilled-512x33-x4", "--seed",
                           str(SEEDS[1]), "--seconds", "5", "--trace", "0"], cwd=tiny_cell.REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"video_s", "peak_gib", "setup_s"} <= set(line["metrics"])
