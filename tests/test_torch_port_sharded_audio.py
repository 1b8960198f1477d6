"""The port's ``generate_video(audio=True)`` and ``generate --audio`` under a
mesh, sequence parallelism and pipeline stages, against the JAX package's.

One spawn of four gloo ranks (tests/test_torch_port_parallel.py:run_ranks:
torch and the port only) runs every case on the narrow AudioVideo bundle of
tests/test_torch_port_audio.py (the AV DiT, the AudioOnly DiT sharing its
audio tensors, the narrow video and audio decoders and vocoder), with JAX's
draws standing in for ``torch.randn``; this process runs JAX's
``generate_video`` with the same options on its virtual 8-device mesh.
Bars, with their reasons:
- >= 35 dB per latent frame, over the audio latents and over the waveform,
  and per RGB frame (the pipeline gate of tests/test_torch_port_audio.py);
- the CLI: rank 0 alone writes the mp4 and the WAV, and its WAV is >= 35 dB
  from the unsharded CLI run's (the same gate, through 16-bit PCM).
"""

from __future__ import annotations

import pickle
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mlx_video_tpu.pipelines import generate as jgen
from mlx_video_tpu_torch import loading as tloading
from mlx_video_tpu_torch.cli import generate as tcli
from mlx_video_tpu_torch.io.safetensors import save_safetensors
from test_torch_port_audio import H, W, _min_frame_psnr, _read_wav, _whole_psnr, av, parts  # noqa: F401 (fixtures)
from test_torch_port_dev import psnr
from test_torch_port_parallel import jax_mesh, run_ranks

SEED, NUM_FRAMES = 4, 9
# (name, audio mode, parallel options, the JAX keys of the draws in the port's order)
RUNS = {
    "joint_mesh_sp": ("joint", dict(mesh=(1, 2, 2), sequence_parallel=True), (0, 5, 1, 6, 2)),
    "joint_stages": ("joint", dict(pipeline_parallel=2, pipeline_tensor=2), (0, 5, 1, 6, 2)),
    "separate_mesh": ("separate", dict(mesh=(2, 1, 2)), (0, 1, 7, 2)),
    "separate_stages": ("separate", dict(pipeline_parallel=2, pipeline_tensor=2), (0, 1, 7, 2)),
}
CLI_FLAGS = {"cli_mesh_sp": ["--mesh", "1,2,2", "--sequence-parallel"],
             "cli_stages": ["--pipeline-parallel", "2", "--pipeline-tensor", "2"]}

_CASES = r'''
from pathlib import Path
from mlx_video_tpu_torch import loading
from mlx_video_tpu_torch.cli import generate as cli
from mlx_video_tpu_torch.io import media
from mlx_video_tpu_torch.parallel import mesh as tmesh
from mlx_video_tpu_torch.pipelines import generate as gen

T = lambda a: torch.from_numpy(a)
bundle = lambda: pickle.loads(inputs["bundle"])  # a fresh copy a run: generate_video shards it in place
emb = {k: T(v) for k, v in inputs["emb"].items()}

class Draws:
    def __init__(self, draws):
        self.left = [np.array(a) for a in draws]
    def __call__(self, size, *, generator=None, device=None, dtype=None):
        want = self.left.pop(0)
        assert tuple(size) == want.shape, (size, want.shape)
        return torch.from_numpy(want).to(device=device, dtype=dtype)

real_randn = torch.randn
out["gen"] = {}
for i, (name, (mode, opts, draws)) in enumerate(inputs["runs"].items()):
    opts = dict(opts)
    if "mesh" in opts:
        opts["mesh"] = tmesh.create_mesh(opts["mesh"], "cpu")
    torch.randn = Draws(draws)
    res = gen.generate_video(bundle(), gen.TextConditioning(emb["video"], audio_embeddings=emb["audio"]),
                             height=inputs["size"], width=inputs["size"], num_frames=inputs["frames"],
                             seed=inputs["seed"], tiling="none", video_encoder="cv2", audio=True, audio_mode=mode,
                             stage1_steps=2, stage2_steps=1, audio_steps=2, dtype=torch.float32,
                             output_path=Path(work) / f"{name}.mp4", **opts)
    assert not torch.randn.left
    torch.randn = real_randn
    out["gen"][name] = (res.latents, res.audio_latents, res.video, res.audio,
                        None if res.video_path is None else str(res.video_path),
                        None if res.audio_path is None else str(res.audio_path))

# the CLI under this launcher's group; main() leaves the group at its end
loading.load_model_bundle = lambda *a, **k: bundle()
writes, real_writer, real_wav = [], media.VideoWriter, gen.save_wav
def writer(path, *a, **k):
    writes.append(Path(path).name)
    return real_writer(path, *a, **k)
def wav(path, *a, **k):
    writes.append(Path(path).name)
    return real_wav(path, *a, **k)
media.VideoWriter, gen.save_wav = writer, wav
for i, (name, flags) in enumerate(inputs["cli"].items()):
    if i:
        join(f"store_cli{i}")
    cli.main(["--prompt", "a tiny cat", "--checkpoint-path", work, "--embeddings", inputs["emb_file"], "--audio",
              "--height", "64", "--width", "64", "--num-frames", "9", "--stage1-steps", "1", "--stage2-steps", "1",
              "--audio-steps", "2", "--tiling", "none", "--output-path", str(Path(work) / f"{name}.mp4"),
              "--device", "cpu", *flags])
out["cli_writes"] = writes
'''


def _draws(ref, key_ids):
    keys = jax.random.split(jax.random.key(SEED), 8)
    frames = 1 + (NUM_FRAMES - 1) // 8
    t = ref.audio_latents.shape[2]
    shapes = {0: (1, 16, frames, H // 64, W // 64), 1: (1, 16, frames, H // 32, W // 32),
              5: (1, 8, t, 16), 6: (1, 8, t, 16), 7: (1, 8, t, 16)}
    out = []
    for k in key_ids:
        if k == 2:
            cl = jax.random.normal(keys[2], (1, frames, H // 32, W // 32, 16), dtype=jnp.float32)
            out.append(np.transpose(np.asarray(cl), (0, 4, 1, 2, 3)))
        else:
            out.append(np.asarray(jax.random.normal(keys[k], shapes[k], dtype=jnp.float32)))
    return out


@pytest.fixture(scope="module")
def refs(parts, tmp_path_factory):
    """JAX's run of every case (its result, and its WAV's waveform)."""
    _, jax_bundle, emb = parts
    work = tmp_path_factory.mktemp("jax_audio")
    jtext = jgen.TextConditioning(jnp.asarray(emb["video"].numpy()),
                                  audio_embeddings=jnp.asarray(emb["audio"].numpy()))
    out = {}
    for name, (mode, opts, _) in RUNS.items():
        opts = dict(opts)
        if "mesh" in opts:
            opts["mesh"] = jax_mesh(opts["mesh"])
        res = jgen.generate_video(jax_bundle, jtext, height=H, width=W, num_frames=NUM_FRAMES, seed=SEED,
                                  tiling="none", video_encoder="cv2", audio=True, audio_mode=mode,
                                  stage1_steps=2, stage2_steps=1, audio_steps=2, dtype=jnp.float32,
                                  output_path=work / f"{name}.mp4", **opts)
        out[name] = res, _read_wav(work / f"{name}.wav")
    return out


@pytest.fixture(scope="module")
def ranks(parts, refs, tmp_path_factory):
    port, _, emb = parts
    work = tmp_path_factory.mktemp("sharded_audio")
    emb_file = work / "emb.safetensors"
    save_safetensors(emb_file, {"video": emb["video"][0], "audio": emb["audio"][0]})
    inputs = dict(bundle=pickle.dumps(port), emb={k: v.numpy() for k, v in emb.items()}, emb_file=str(emb_file),
                  size=H, frames=NUM_FRAMES, seed=SEED, cli=CLI_FLAGS,
                  runs={name: (mode, opts, _draws(refs[name][0], keys)) for name, (mode, opts, keys) in RUNS.items()})
    return run_ranks(_CASES, 4, work, inputs, timeout=400), work


@pytest.mark.parametrize("name", list(RUNS))
def test_generate_video_with_audio_sharded_matches_jax(refs, ranks, name):
    """Joint (the AV DiT) and separate (the AudioOnly DiT after the video)
    audio under a mesh with SP, a mesh with a data axis, and 2 stages x 2 TP
    ways: every rank's video, latents, audio latents and waveform against
    JAX's run with the same options; the mp4 and the WAV from rank 0."""
    ref, ref_wav = refs[name]
    outs, work = ranks
    t = ref.audio_latents.shape[2]
    for r, out in enumerate(outs):
        latents, audio_latents, video, audio, video_path, audio_path = out["gen"][name]
        assert (video_path is not None) == (audio_path is not None) == (r == 0)
        assert audio_latents.shape == ref.audio_latents.shape == (1, 8, t, 16)
        assert _min_frame_psnr(latents, ref.latents) >= 35.0
        assert _whole_psnr(audio_latents, ref.audio_latents) >= 35.0
        assert min(psnr(video[:, :, i], ref.video[:, :, i], 2.0) for i in range(NUM_FRAMES)) >= 35.0
        assert audio.shape == ref_wav.shape == (2, 240 * (4 * t - 3))
        assert psnr(audio, ref_wav, 2.0) >= 35.0
    assert (work / f"{name}.mp4").stat().st_size > 0
    assert psnr(_read_wav(work / f"{name}.wav"), ref_wav, 2.0) >= 35.0


def _wav(path) -> np.ndarray:
    with wave.open(str(path), "rb") as wf:
        return np.frombuffer(wf.readframes(wf.getnframes()), np.int16).astype(np.float64)


def test_cli_with_audio_under_four_ranks_writes_one_video_and_one_wav(parts, ranks, monkeypatch, tmp_path):
    """``generate --audio`` with ``--mesh 1,2,2 --sequence-parallel`` and with
    ``--pipeline-parallel 2 --pipeline-tensor 2`` over four gloo ranks: rank 0
    alone writes (each run one mp4 and one WAV), and its WAV matches the
    unsharded CLI run's."""
    port, _, _ = parts
    outs, work = ranks
    names = [f"{n}{ext}" for n in CLI_FLAGS for ext in (".temp.mp4", ".wav")]
    assert [o["cli_writes"] for o in outs] == [names, [], [], []]
    monkeypatch.setattr(tloading, "load_model_bundle", lambda *a, **k: pickle.loads(pickle.dumps(port)))
    plain = tmp_path / "plain.mp4"
    tcli.main(["--prompt", "a tiny cat", "--checkpoint-path", str(tmp_path), "--embeddings",
               str(work / "emb.safetensors"), "--audio", "--height", "64", "--width", "64", "--num-frames", "9",
               "--stage1-steps", "1", "--stage2-steps", "1", "--audio-steps", "2", "--tiling", "none",
               "--output-path", str(plain), "--device", "cpu"])
    ref = _wav(tmp_path / "plain.wav")
    for name in CLI_FLAGS:
        assert (work / f"{name}.mp4").stat().st_size > 0
        got = _wav(work / f"{name}.wav")
        assert got.shape == ref.shape and psnr(got, ref, 65535.0) >= 35.0, name
