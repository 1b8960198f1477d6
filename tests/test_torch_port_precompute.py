"""The port's training-data path against the JAX package, on the CPU: the
log-mel processor, the audio VAE encoder and its loader, precompute_dataset
with every kind of file it writes, the ffmpeg PCM reader, and the precompute
CLI on a tiny snapshot.

Bars, each with its reason:
- log-mel: max |d| <= 1e-5 (the same numpy code; both read equal here);
- the audio encoder in fp32: relative L2 <= 5e-4 (fp32 convs summed in
  another order), the bar of tests/test_audio.py's cross-check;
- the loader: bit-exact, on files the test writes;
- precompute_dataset: the same files, keys, dtypes and shapes; video and
  audio latents and caption embeddings within 5e-4 relative L2 (fp32 convs
  and matmuls in another order; the ROADMAP gate); bucket picks equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_conditioned import _write_mp4
from test_torch_port_dev import ENC_KW, _encoder, _jax_tree
from test_torch_port_text_encoder import GEMMA, STACKED, encoder_trees, write_text_encoder_snapshot  # noqa: F401

from mlx_video_tpu.config import VideoVAEConfig as JaxVAEConfig
from mlx_video_tpu.io import vae_weights as jvae
from mlx_video_tpu.io.safetensors import SafetensorsReader as JaxReader
from mlx_video_tpu.models.ltx import text_encoder as jte
from mlx_video_tpu.models.ltx.audio_vae import audio_vae as jaudio
from mlx_video_tpu.models.ltx.audio_vae import processing as jproc
from mlx_video_tpu.models.ltx.video_vae import encoder as jenc
from mlx_video_tpu.trainer import precompute as jpre
from mlx_video_tpu_torch import config as tconfig
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import vae_weights as tvae
from mlx_video_tpu_torch.io.safetensors import SafetensorsReader, save_safetensors
from mlx_video_tpu_torch.models.ltx import text_encoder as tte
from mlx_video_tpu_torch.models.ltx.audio_vae import audio_vae as taudio
from mlx_video_tpu_torch.models.ltx.audio_vae import processing as tproc
from mlx_video_tpu_torch.models.ltx.video_vae import encoder as tenc
from mlx_video_tpu_torch.trainer import precompute as tpre

NARROW_AUDIO = dict(ch=16, ch_mult=(1, 2, 4), num_res_blocks=1, in_channels=2, out_ch=2, z_channels=8, mel_bins=64,
                    resolution=64, attn_resolutions=(32,), mid_block_add_attention=True)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _waveform(seconds: float, rate: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)])
    return (0.5 * tone + 0.1 * rng.normal(size=tone.shape)).astype(np.float32)


@pytest.mark.parametrize("rate", [16000, 24000])
def test_audio_processor_matches_jax(rate):
    """The 24 kHz waveform takes the resample path."""
    wave = _waveform(0.7, rate, 1)
    ref = jproc.AudioProcessor().waveform_to_mel(wave, rate)
    got = tproc.AudioProcessor().waveform_to_mel(wave, rate)
    assert got.shape == ref.shape == (1, 2, 1 + (int(0.7 * 16000) - 1024) // 160, 64)
    assert np.abs(got - ref).max() <= 1e-5
    short = _waveform(0.03, 16000, 2)  # shorter than one FFT window: padded to one frame
    np.testing.assert_array_equal(tproc.AudioProcessor().waveform_to_mel(short, 16000),
                                  jproc.AudioProcessor().waveform_to_mel(short, 16000))


def _audio_encoder(kw: dict, seed: int):
    """A narrow or default-geometry encoder: the JAX init with statistics
    drawn, bridged into the port's module."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jaudio.init_audio_encoder(jax.random.key(seed), jaudio.AudioVAEConfig(**kw),
                                                              dtype=jnp.float32))
    stats = tree["per_channel_statistics"]
    stats["mean_of_means"] = rng.normal(size=stats["mean_of_means"].shape).astype(np.float32) * 0.2
    stats["std_of_means"] = rng.uniform(0.7, 1.3, size=stats["std_of_means"].shape).astype(np.float32)
    module = taudio.AudioEncoder(taudio.AudioVAEConfig(**kw), device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(module, tree, stacked=())
    return tree, module


@pytest.mark.parametrize("geometry", ["narrow_with_attention", "default"])
def test_audio_encoder_matches_jax(geometry):
    kw = NARROW_AUDIO if geometry == "narrow_with_attention" else {}
    tree, enc = _audio_encoder(kw, 5)
    back = jax_bridge.audio_encoder_to_jax_tree(enc)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    if kw:
        assert "attn_1" in tree["mid"] and tree["down"]["1"]["attn"]  # attention at resolution 32
    frames = 65 if kw else 37
    spec = np.random.default_rng(6).normal(size=(1, 2, frames, 64)).astype(np.float32)
    ref = np.asarray(jaudio.audio_encoder_apply(jax.tree.map(jnp.asarray, tree), jaudio.AudioVAEConfig(**kw),
                                                jnp.asarray(spec)))
    cfg = taudio.AudioVAEConfig(**kw)
    got = taudio.audio_encoder_apply(enc, cfg, torch.from_numpy(spec))
    assert got.shape == ref.shape == (1, 8, (frames + 3) // 4, 16)
    assert _rel_l2(got.numpy(), ref) <= 5e-4
    channels_last = taudio.audio_encoder_apply(enc, cfg, torch.from_numpy(spec).permute(0, 2, 3, 1))
    assert torch.equal(channels_last, got)
    with pytest.raises(ValueError, match="4D"):
        taudio.audio_encoder_apply(enc, cfg, torch.from_numpy(spec[0]))


_STAT_NAMES = {"std_of_means": ("std_of_means", "std-of-means", "_std_of_means"),
               "mean_of_means": ("mean_of_means", "mean-of-means", "_mean_of_means")}


def _audio_checkpoint(enc, prefix: str, spelling: int, drop=None) -> dict:
    """The encoder as a checkpoint: ``prefix`` on the weights, CausalConv
    ``.conv`` nesting, the statistics under spelling ``spelling``."""
    out = {}
    for name, v in enc.state_dict().items():
        if name == drop:
            continue
        if name.startswith("per_channel_statistics."):
            stat = name.split(".")[-1]
            stat_prefix = "audio_vae.per_channel_statistics." if prefix.startswith("audio_vae") else \
                "per_channel_statistics."
            out[stat_prefix + _STAT_NAMES[stat][spelling]] = v.numpy()
        else:
            parts = name.split(".")
            out[prefix + ".".join(parts[:-1] + ["conv", parts[-1]])] = v.numpy()
    return out


@pytest.mark.parametrize("prefix, spelling", [("encoder.", 0), ("audio_vae.encoder.", 1), ("encoder.", 2)])
def test_audio_encoder_loader_matches_jax(tmp_path, prefix, spelling):
    tree, source = _audio_encoder(NARROW_AUDIO, 7)
    path = tmp_path / "audio_vae.safetensors"
    from mlx_video_tpu.io.safetensors import save_safetensors as jsave

    jsave(path, _audio_checkpoint(source, prefix, spelling))
    params = jaudio.init_audio_encoder(jax.random.key(0), jaudio.AudioVAEConfig(**NARROW_AUDIO), dtype=jnp.float32)
    jvae.load_audio_vae_weights(path, params, None, dtype=jnp.float32)
    ours = taudio.init_audio_encoder(torch.Generator().manual_seed(1), taudio.AudioVAEConfig(**NARROW_AUDIO),
                                     device="cpu", dtype=torch.float32)
    assert tvae.load_audio_vae_weights(path, encoder=ours) == len(ours.state_dict())
    for a, b in zip(jax.tree.leaves(jax_bridge.audio_encoder_to_jax_tree(ours)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for k, v in source.state_dict().items():
        assert torch.equal(ours.state_dict()[k], v), k
    jsave(tmp_path / "short.safetensors", _audio_checkpoint(source, prefix, spelling, drop="conv_out.bias"))
    with pytest.raises(ValueError, match="audio VAE encoder: 1 parameters not in the file"):
        tvae.load_audio_vae_weights(tmp_path / "short.safetensors", encoder=ours)


class _FakeFfmpeg:
    """Stands in for ``subprocess.run``: s16le PCM of a seeded stereo
    waveform as long as the clip, or a failure."""

    def __init__(self, seconds: float, fail=None):
        import subprocess

        self.seconds, self.fail, self.calls, self.run = seconds, fail, [], subprocess.run

    def __call__(self, cmd, capture_output=True, **kw):
        import subprocess

        if cmd[0] != "ffmpeg":  # other callers run as they would
            return self.run(cmd, capture_output=capture_output, **kw)
        self.calls.append(cmd)
        if self.fail == "missing":
            raise FileNotFoundError("ffmpeg")
        rate = int(cmd[cmd.index("-ar") + 1])
        wave = _waveform(self.seconds, rate, len(self.calls))
        pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16).T.tobytes()
        code, out = (1, b"") if self.fail == "error" else (0, b"" if self.fail == "empty" else pcm)
        return subprocess.CompletedProcess(cmd, code, out, b"")


@pytest.mark.parametrize("fail", [None, "missing", "error", "empty"])
def test_extract_audio_pcm_matches_jax(monkeypatch, tmp_path, fail):
    import subprocess

    runs = []
    for mod in (jpre, tpre):
        fake = _FakeFfmpeg(0.2, fail)
        monkeypatch.setattr(subprocess, "run", fake)
        runs.append((mod.extract_audio_pcm(tmp_path / "clip.mp4", 16000), fake.calls))
    (ref, ref_calls), (got, got_calls) = runs
    assert got_calls == ref_calls
    if fail:
        assert got is None and ref is None
    else:
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[0].shape == (2, 3200) and got[1] == ref[1] == 16000


def test_prompts_file_and_buckets_match_jax():
    stems = ["a", "b"]
    for text in ("a: a cat\nb: a dog: running\n", "one shared prompt: with a colon\n", ""):
        lines = {}
        for line in text.splitlines():  # the JAX main's parsing, inline there
            if ":" in line:
                stem, prompt = line.split(":", 1)
                lines[stem.strip()] = prompt.strip()
        if text.strip() and not (lines.keys() & set(stems)):
            lines = {s: " ".join(text.split()) for s in stems}
        assert tpre.parse_prompts_file(text, stems) == lines
    spec = "768x512x65; 512x512x33;"
    assert tpre.parse_buckets(spec) == jpre.parse_buckets(spec)
    clip = np.zeros((40, 300, 500, 3), np.float32)
    for buckets in (jpre.parse_buckets(spec), [(64, 64, 9), (128, 64, 17)]):
        assert tpre.select_bucket(clip, buckets) == jpre.select_bucket(clip, buckets)
        for b in buckets:
            np.testing.assert_array_equal(tpre.fit_to_bucket(clip[:5], b), jpre.fit_to_bucket(clip[:5], b))


def _text_fns(trees):
    """prompt -> conditions in both packages: ``encode_tokens`` of the tiny
    text encoder on ids from the prompt's bytes, left-padded to 12."""
    jcfg, tcfg, tree, model = trees
    jtree = jax.tree.map(jnp.asarray, tree)

    def ids(prompt: str):
        raw = list(prompt.encode())[:12]
        ids_ = np.zeros((1, 12), np.int32)
        mask = np.zeros((1, 12), np.int32)
        if raw:
            ids_[0, -len(raw):], mask[0, -len(raw):] = raw, 1
        else:
            mask[0, -1] = 1
        return ids_, mask

    def jax_fn(prompt):
        i, m = ids(prompt)
        video, audio = jte.encode_tokens(jtree, jcfg, jnp.asarray(i), jnp.asarray(m), True)
        return {"video_prompt_embeds": np.asarray(video[0], np.float32),
                "audio_prompt_embeds": np.asarray(audio[0], np.float32),
                "prompt_attention_mask": np.ones((video.shape[1],), bool)}

    def port_encode(prompt):
        i, m = ids(prompt)
        with torch.no_grad():
            return tte.encode_tokens(model, tcfg, torch.from_numpy(i).long(), torch.from_numpy(m), True)

    return jax_fn, tpre.make_text_encode_fn(port_encode)


def _clips(root):
    videos = root / "videos"
    videos.mkdir(parents=True)
    for i, frames in enumerate((13, 11)):
        _write_mp4(videos / f"clip{i}.mp4", frames, 96, 30 + i)
    refs = root / "refs"
    refs.mkdir()
    _write_mp4(refs / "clip0.mp4", 5, 80, 40)  # clip1 has no reference
    prompts = {"clip0": "a red car", "clip1": "a cat: jumping"}
    return sorted(videos.iterdir()), refs, prompts


@pytest.mark.parametrize("reference", ["reference_dir", "reference_fn"])
def test_precompute_dataset_matches_jax(tmp_path, monkeypatch, encoder_trees, reference):  # noqa: F811
    """Two clips, buckets, prompts, a reference (a directory with one of the
    two clips' references, or Canny edges) and audio through
    make_audio_encode_fn (narrow encoders both sides, the same PCM)."""
    import subprocess

    videos, refs, prompts = _clips(tmp_path)
    enc = _encoder(8)
    vcfg = tconfig.VideoVAEConfig(**ENC_KW)
    jtree = _jax_tree(enc)
    jax_text, port_text = _text_fns(encoder_trees)
    _write_audio_encoder(tmp_path / "snap", 9)
    for mod in (jaudio, taudio):  # make_audio_encode_fn builds AudioVAEConfig(): the narrow one here
        narrow = mod.AudioVAEConfig(**NARROW_AUDIO)
        monkeypatch.setattr(mod, "AudioVAEConfig", lambda narrow=narrow: narrow)
    buckets = [(64, 64, 9), (128, 64, 17), (64, 96, 9)]
    common = dict(prompts=prompts, buckets=buckets, fps=25.0,
                  reference_dir=refs if reference == "reference_dir" else None,
                  reference_fn=None if reference == "reference_dir" else jpre.compute_edge_reference)
    monkeypatch.setattr(subprocess, "run", _FakeFfmpeg(9 / 25.0))
    n_ref = jpre.precompute_dataset(
        videos, tmp_path / "jax", lambda t: jenc.video_encoder_apply(jtree, JaxVAEConfig(**ENC_KW), jnp.asarray(t)),
        text_encode_fn=jax_text, audio_encode_fn=jpre.make_audio_encode_fn(tmp_path / "snap"), **common)
    monkeypatch.setattr(subprocess, "run", _FakeFfmpeg(9 / 25.0))
    common["reference_fn"] = None if reference == "reference_dir" else tpre.compute_edge_reference
    n_got = tpre.precompute_dataset(
        videos, tmp_path / "port", tpre.make_video_encode_fn(enc, vcfg), text_encode_fn=port_text,
        audio_encode_fn=tpre.make_audio_encode_fn(tmp_path / "snap", device="cpu"), **common)
    assert n_got == n_ref == 2
    ref_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.safetensors"))
    got_files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.safetensors"))
    assert got_files == ref_files
    assert len(ref_files) == 3 * 2 + (1 if reference == "reference_dir" else 2)
    for rel in ref_files:
        with JaxReader(tmp_path / "jax" / rel) as r:
            ref = {k: np.asarray(r.get(k)) for k in r.keys()}
        with SafetensorsReader(tmp_path / "port" / rel) as r:
            got = {k: r.get(k).numpy() for k in r.keys()}
        assert sorted(got) == sorted(ref), rel
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, (rel, k)
            if got[k].dtype == np.float32 and got[k].size > 1:
                assert _rel_l2(got[k], ref[k]) <= 5e-4, (rel, k)
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{rel} {k}")
    with SafetensorsReader(tmp_path / "port" / "latents" / "latent_clip0.safetensors") as r:
        assert tuple(r.shape("latents")) == (16, 2, 3, 2)  # bucket (64, 96, 9) of the 96 x 96 x 13 clip
    with SafetensorsReader(tmp_path / "port" / "audio_latents" / "latent_clip1.safetensors") as r:
        assert int(r.get("num_time_steps")[0]) == r.shape("latents")[1] == (1 + (5760 - 1024) // 160 + 3) // 4


def _write_audio_encoder(root, seed: int):
    """A narrow audio VAE encoder as ``root/audio_vae``'s file."""
    _, aenc = _audio_encoder(NARROW_AUDIO, seed)
    (root / "audio_vae").mkdir(parents=True)
    save_safetensors(root / "audio_vae" / "diffusion_pytorch_model.safetensors",
                     {(k if k.startswith("per_channel") else f"encoder.{k}"): v for k, v in aenc.state_dict().items()})


def test_precompute_skips_audio_without_ffmpeg(tmp_path, monkeypatch):
    import subprocess

    videos, _, prompts = _clips(tmp_path)
    _write_audio_encoder(tmp_path / "snap", 9)
    narrow = taudio.AudioVAEConfig(**NARROW_AUDIO)
    monkeypatch.setattr(taudio, "AudioVAEConfig", lambda: narrow)
    monkeypatch.setattr(subprocess, "run", _FakeFfmpeg(1.0, "missing"))
    n = tpre.precompute_dataset(videos, tmp_path / "out", tpre.make_video_encode_fn(_encoder(8), tconfig.VideoVAEConfig(
        **ENC_KW)), prompts=prompts, buckets=[(64, 64, 9)],
        audio_encode_fn=tpre.make_audio_encode_fn(tmp_path / "snap", device="cpu"))
    assert n == 2 and not list((tmp_path / "out" / "audio_latents").iterdir())
    with SafetensorsReader(tmp_path / "out" / "conditions" / "condition_clip1.safetensors") as r:
        assert bytes(r.get("prompt").numpy()) == b"a cat: jumping"


def _tiny_snapshot(root, te_model):
    """A tiny text-encoder snapshot plus a narrow video VAE encoder in
    vae/ and a narrow audio VAE encoder in audio_vae/."""
    write_text_encoder_snapshot(root, te_model)
    (root / "vae").mkdir()
    enc = _encoder(11)
    stats = {"mean": "mean-of-means", "std": "std-of-means"}
    save_safetensors(root / "vae" / "diffusion_pytorch_model.safetensors", {
        (f"per_channel_statistics.{stats[k.split('.')[-1]]}" if k.startswith("per_channel") else f"encoder.{k}"): v
        for k, v in enc.state_dict().items()})
    _write_audio_encoder(root, 12)
    return enc


def test_cli_precomputes_on_the_cpu(tmp_path, monkeypatch, capsys, encoder_trees):  # noqa: F811
    """python -m mlx_video_tpu_torch.precompute --device cpu on a tiny
    snapshot (the narrow encoders patched in as the default configs): every
    clip's latents (equal to the encoder's on the bucketed clip),
    conditions (tokenizer and text encoder), audio latents and edge
    references; then the copy mode of --audio-latents-dir, where --debug
    says that it does nothing; --caption and a missing CUDA exit by name."""
    import subprocess

    from mlx_video_tpu_torch import precompute as shim
    from mlx_video_tpu_torch.io import media

    videos, _, _ = _clips(tmp_path)
    (tmp_path / "prompts.txt").write_text("a red car at night\n")  # one shared prompt
    snap = tmp_path / "snap"
    enc = _tiny_snapshot(snap, encoder_trees[3])
    vcfg = tconfig.VideoVAEConfig(**ENC_KW)
    monkeypatch.setattr(tconfig, "VideoVAEConfig", lambda: vcfg)
    narrow = taudio.AudioVAEConfig(**NARROW_AUDIO)
    monkeypatch.setattr(taudio, "AudioVAEConfig", lambda: narrow)
    monkeypatch.setattr(subprocess, "run", _FakeFfmpeg(0.5))
    argv = ["--videos", str(videos[0].parent), "--model-repo", str(snap), "--prompts-file",
            str(tmp_path / "prompts.txt"), "--resolution-buckets", "64x64x9", "--device", "cpu"]
    out = tmp_path / "data"
    shim.main([*argv, "--output", str(out), "--audio", "--reference-edges"])
    for sub in ("latents", "conditions", "audio_latents", "reference_latents"):
        assert len(list((out / sub).iterdir())) == 2, sub
    with SafetensorsReader(out / "conditions" / "condition_clip0.safetensors") as r:
        assert r.shape("video_prompt_embeds") == r.shape("audio_prompt_embeds") == (1024, GEMMA["hidden_size"])
        assert bool(r.get("prompt_attention_mask").all())
    with SafetensorsReader(out / "latents" / "latent_clip1.safetensors") as r:
        got = r.get("latents")
    frames = tpre.fit_to_bucket(media.load_video(videos[1]), (64, 64, 9))
    pixels = media.prepare_video_for_encoding(frames, 64, 64).astype(np.float32)
    loaded = tenc.init_video_encoder(torch.Generator().manual_seed(0), vcfg, device="cpu", dtype=torch.bfloat16)
    tvae.load_video_encoder_weights(snap / "vae" / "diffusion_pytorch_model.safetensors", loaded)
    assert torch.equal(got, tpre.make_video_encode_fn(loaded, vcfg)(pixels)[0])
    assert torch.equal(loaded.conv_in.weight, enc.conv_in.weight.bfloat16())

    copied = tmp_path / "copied"
    capsys.readouterr()
    shim.main([*argv, "--output", str(copied), "--audio-latents-dir", str(out / "audio_latents"), "--debug"])
    assert "--debug is accepted but this package prints no debug output" in capsys.readouterr().out
    for f in (out / "audio_latents").iterdir():
        with SafetensorsReader(f) as a, SafetensorsReader(copied / "audio_latents" / f.name) as b:
            assert a.keys() == b.keys() and all(torch.equal(a.get(k), b.get(k)) for k in a.keys())
    with pytest.raises(SystemExit, match="--caption"):
        shim.main([*argv, "--output", str(out), "--caption"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        shim.main([*argv[:-2], "--output", str(out)])
