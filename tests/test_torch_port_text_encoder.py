"""The port's Gemma-3 text encoder against the JAX package, on the CPU: the
Gemma hidden states, the hidden-state aggregation, the connectors,
``encode_tokens`` in fp32 and in W8A8, the weight loaders and the
tokenizer path of ``LTX2TextEncoder``.

Weights come from the JAX init with every leaf then drawn from a seeded
numpy generator (norm scales, registers and biases included, so none is a
no-op), bridged into the port's modules (io/jax_bridge.py with the Gemma
layer stack). Bars, each with its reason:
- Gemma hidden states on a tiny config with sliding-window and global
  layers, padded and unpadded: relative L2 <= 5e-4 per state in fp32 (fp32
  matmuls and softmax summed in another order);
- aggregation, connectors and encode_tokens: <= 5e-4; in W8A8 <= 1e-3 (a
  code moved across a half by an upstream ulp moves a product by ~1/127 of
  a row's absmax);
- the loaders: bit-exact, on files the test writes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_video_tpu.io import text_encoder_weights as jtew
from mlx_video_tpu.models import gemma3 as jg
from mlx_video_tpu.models.ltx import text_encoder as jte
from mlx_video_tpu.ops import int8 as jint8
from mlx_video_tpu_torch.io import jax_bridge
from mlx_video_tpu_torch.io import text_encoder_weights as ttew
from mlx_video_tpu_torch.io.safetensors import save_safetensors
from mlx_video_tpu_torch.models import gemma3 as tg
from mlx_video_tpu_torch.models.ltx import text_encoder as tte
from mlx_video_tpu_torch.ops.linear import Int8Linear, Linear, QuantLinear

GEMMA = dict(vocab_size=300, hidden_size=48, intermediate_size=96, num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, sliding_window=3, sliding_window_pattern=2)
STACKED = jax_bridge.GEMMA_STACKED_KEYS


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _randomize(tree, seed: int, scale: float = 0.2):
    """Every leaf drawn anew: norms, registers and biases too."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), tree)


@pytest.fixture(scope="module")
def encoder_trees():
    """A tiny text encoder (JAX tree, its port module, the two configs)."""
    jcfg, tcfg = jg.Gemma3TextConfig(**GEMMA), tg.Gemma3TextConfig(**GEMMA)
    tree = jax.tree.map(np.asarray, jte.init_text_encoder_params(
        jax.random.key(0), jcfg, hidden_dim=GEMMA["hidden_size"], dtype=jnp.float32))
    tree = _randomize(tree, 1)
    tree["language_model"]["embed_tokens"]["weight"] *= 5.0  # the JAX init's scale after sqrt(hidden)
    model = tte.TextEncoderModel(tcfg, GEMMA["hidden_size"], device="cpu", dtype=torch.float32)
    jax_bridge.load_jax_params(model, tree, stacked=STACKED)
    return jcfg, tcfg, tree, model


def _ids_and_mask(padded: bool, b: int = 2, t: int = 9, seed: int = 3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GEMMA["vocab_size"], size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    if padded:
        mask[0, :4] = 0  # left padding, as the tokenizer pads
        mask[1, :1] = 0
    return ids, mask


@pytest.mark.parametrize("padded", [False, True])
def test_gemma_hidden_states_match_jax(encoder_trees, padded):
    jcfg, tcfg, tree, model = encoder_trees
    assert [tcfg.is_global_layer(i) for i in range(4)] == [False, True, False, True]
    ids, mask = _ids_and_mask(padded)
    ref = jg.gemma3_hidden_states(jax.tree.map(jnp.asarray, tree["language_model"]), jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask))
    got = tg.gemma3_hidden_states(model.language_model, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert len(got) == len(ref) == GEMMA["num_hidden_layers"] + 1
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        assert _rel_l2(g.numpy(), r) <= 5e-4, i


@pytest.mark.parametrize("t, window", [(6, None), (6, 2), (1, 3)])
def test_causal_mask_bias_matches_jax(t, window):
    mask = np.ones((2, t), np.int32)
    mask[0, : t // 2] = 0
    for m in (None, mask):
        ref = np.asarray(jg.causal_mask_bias(t, None if m is None else jnp.asarray(m), window))
        got = tg.causal_mask_bias(t, None if m is None else torch.from_numpy(m), window)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_layer_schedule_matches_jax():
    for pattern in (2, 6):
        jcfg = jg.Gemma3TextConfig(num_hidden_layers=12, sliding_window_pattern=pattern)
        tcfg = tg.Gemma3TextConfig(num_hidden_layers=12, sliding_window_pattern=pattern)
        jglob, jbases = jg._layer_schedule(jcfg)
        tglob, tbases = tg._layer_schedule(tcfg)
        assert list(np.asarray(jglob)) == tglob
        np.testing.assert_array_equal(np.asarray(jbases), np.asarray(tbases, np.float32))
    for d in ({"text_config": {"num_hidden_layers": 3}}, {"layer_types": ["sliding_attention"] * 5 + ["full_attention"]},
              {"layer_types": ["sliding_attention"] * 2}):
        assert tg.Gemma3TextConfig.from_dict(d) == tg.Gemma3TextConfig(**vars(jg.Gemma3TextConfig.from_dict(d)))


@pytest.mark.parametrize("padding_side", ["left", "right"])
def test_norm_and_concat_matches_jax(rng, padding_side):
    states = [rng.normal(size=(2, 7, 12)).astype(np.float32) * (i + 1) for i in range(5)]
    mask = np.ones((2, 7), np.int32)
    mask[0, :3] = 0 if padding_side == "left" else 1
    if padding_side == "right":
        mask[0, 4:] = 0
    ref = jte.norm_and_concat_hidden_states([jnp.asarray(s) for s in states], jnp.asarray(mask), padding_side)
    got = tte.norm_and_concat_hidden_states([torch.from_numpy(s) for s in states], torch.from_numpy(mask),
                                            padding_side)
    assert got.shape == (2, 7, 60) and got.dtype == torch.float32
    assert _rel_l2(got.numpy(), np.asarray(ref)) <= 5e-4


def test_connector_matches_jax(encoder_trees, rng):
    _, _, tree, model = encoder_trees
    hs = rng.normal(size=(2, 9, GEMMA["hidden_size"])).astype(np.float32)
    _, mask = _ids_and_mask(True)
    ref = jte.connector_apply(jax.tree.map(jnp.asarray, tree["video_embeddings_connector"]), jnp.asarray(hs),
                              jnp.asarray(mask))
    got = tte.connector_apply(model.video_embeddings_connector, torch.from_numpy(hs), torch.from_numpy(mask))
    assert _rel_l2(got.numpy(), np.asarray(ref)) <= 5e-4
    regs = tree["video_embeddings_connector"]["learnable_registers"]
    np.testing.assert_array_equal(
        tte.replace_padding_with_registers(torch.from_numpy(hs), torch.from_numpy(mask), torch.from_numpy(regs)).numpy(),
        np.asarray(jte.replace_padding_with_registers(jnp.asarray(hs), jnp.asarray(mask), jnp.asarray(regs))))
    for ref_t, got_t in zip(jte._connector_rope(9, 30, 128), tte._connector_rope(9, 30, 128)):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


@pytest.mark.parametrize("w8a8", [False, True])
def test_encode_tokens_matches_jax(encoder_trees, w8a8):
    jcfg, tcfg, tree, model = encoder_trees
    ids, mask = _ids_and_mask(True)
    jtree = jax.tree.map(jnp.asarray, tree)
    if w8a8:
        jtree = jint8.quantize_text_encoder_w8a8(jtree)
        model = tte.TextEncoderModel(tcfg, GEMMA["hidden_size"], device="cpu", dtype=torch.float32)
        jax_bridge.load_jax_params(model, tree, stacked=STACKED)
        from mlx_video_tpu_torch.ops.int8 import quantize_text_encoder_w8a8

        assert quantize_text_encoder_w8a8(model) is model
        int8 = [n for n, m in model.named_modules() if isinstance(m, Int8Linear)]
        assert len(int8) == 7 * GEMMA["num_hidden_layers"] + 1
        assert isinstance(model.video_embeddings_connector.transformer_1d_blocks[0].attn1.to_q, Linear)  # dense
        ours = jax_bridge.module_to_jax_tree(model, STACKED)
        np.testing.assert_array_equal(ours["feature_extractor"]["aggregate_embed"]["int8_weight"],
                                      np.asarray(jtree["feature_extractor"]["aggregate_embed"]["int8_weight"]))
        np.testing.assert_array_equal(ours["language_model"]["layers"]["mlp"]["down_proj"]["int8_weight"],
                                      np.asarray(jtree["language_model"]["layers"]["mlp"]["down_proj"]["int8_weight"]))
    rv, ra = jte.encode_tokens(jtree, jcfg, jnp.asarray(ids), jnp.asarray(mask), True)
    gv, ga = tte.encode_tokens(model, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask), True)
    assert gv.shape == rv.shape == (2, 9, GEMMA["hidden_size"])
    bar = 1e-3 if w8a8 else 5e-4
    assert _rel_l2(gv.numpy(), np.asarray(rv)) <= bar and _rel_l2(ga.numpy(), np.asarray(ra)) <= bar


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def _write_gemma(directory, model: tg.Gemma3Model, prefix: str = "language_model.model.", shards: int = 1):
    """An HF-layout Gemma snapshot of ``model``: (out, in) linears, one key a
    layer, a config.json; in ``shards`` files with an index when more."""
    directory.mkdir(parents=True, exist_ok=True)
    state = {prefix + k: v for k, v in model.state_dict().items()}
    state["vision_tower.unused.weight"] = torch.zeros(2)  # not the text stack: skipped by both
    keys = sorted(state)
    if shards == 1:
        save_safetensors(directory / "model.safetensors", state)
    else:
        (directory / "model.safetensors.index.json").write_text("{}")
        for i in range(shards):
            save_safetensors(directory / f"model-{i:05d}-of-{shards:05d}.safetensors",
                             {k: state[k] for k in keys[i::shards]})
    (directory / "config.json").write_text(json.dumps({"text_config": GEMMA}))


def _assert_trees_equal(got, ref):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


@pytest.mark.parametrize("prefix, shards", [("language_model.model.", 1), ("model.", 3), ("", 1)])
def test_gemma_loader_matches_jax(encoder_trees, tmp_path, prefix, shards):
    jcfg, tcfg, _, model = encoder_trees
    _write_gemma(tmp_path, model.language_model, prefix, shards)
    ref = jtew.load_gemma_weights(tmp_path, jcfg, dtype=jnp.float32)
    got = ttew.load_gemma_weights(tmp_path, tcfg, dtype=torch.float32, device="cpu")
    _assert_trees_equal(jax_bridge.module_to_jax_tree(got, STACKED), jax.tree.map(np.asarray, ref))


def test_gemma_loader_reads_mlx_quantized_linears(encoder_trees, tmp_path):
    """uint32 words with scales and biases: a QuantLinear (and a dequantized
    embedding table), as the JAX loader's quant_weight leaves."""
    from mlx_video_tpu_torch.ops.quant import quantize_affine

    jcfg, tcfg, _, model = encoder_trees
    state = {f"model.{k}": v for k, v in model.language_model.state_dict().items()}
    for key in [k for k in state if k.endswith("_proj.weight") or k == "model.embed_tokens.weight"]:
        packed, scales, biases = quantize_affine(state[key], 16, 4)
        state[key] = packed.view(torch.uint32)
        state[key[: -len("weight")] + "scales"], state[key[: -len("weight")] + "biases"] = scales, biases
    save_safetensors(tmp_path / "model.safetensors", state)
    ref = jtew.load_gemma_weights(tmp_path, jcfg, dtype=jnp.float32)
    got = ttew.load_gemma_weights(tmp_path, tcfg, dtype=torch.float32, device="cpu")
    assert isinstance(got.layers[0].mlp.up_proj, QuantLinear) and got.layers[0].mlp.up_proj.bits == 4
    _assert_trees_equal(jax_bridge.module_to_jax_tree(got, STACKED), jax.tree.map(np.asarray, ref))


def test_gemma_loader_refuses_a_missing_layer(encoder_trees, tmp_path):
    jcfg, tcfg, _, model = encoder_trees
    state = {k: v for k, v in model.language_model.state_dict().items() if not k.startswith("layers.3.mlp.up")}
    save_safetensors(tmp_path / "model.safetensors", state)
    with pytest.raises(ValueError, match="3/4 layers"):
        ttew.load_gemma_weights(tmp_path, tcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(FileNotFoundError):
        ttew.load_gemma_weights(tmp_path / "none", tcfg, device="cpu")


def _connector_state(model: tte.TextEncoderModel, layout: str) -> dict:
    """The feature extractor and connectors under one of the four layouts'
    key names (reference checkpoint names: to_out.0, ff.net.0.proj, ff.net.2)."""
    def ref_name(k):
        return k.replace(".to_out.", ".to_out.0.").replace(".ff.proj_in.", ".ff.net.0.proj.").replace(
            ".ff.proj_out.", ".ff.net.2.")

    prefixes = {
        "dit": ("model.diffusion_model.video_embeddings_connector.", "model.diffusion_model.audio_embeddings_connector.",
                "text_embedding_projection.aggregate_embed.weight"),
        "diffusers": ("video_connector.", "audio_connector.", "text_proj_in.weight"),
    }[layout]
    state = {prefixes[2]: model.feature_extractor.aggregate_embed.weight}
    for prefix, conn in zip(prefixes[:2], (model.video_embeddings_connector, model.audio_embeddings_connector)):
        state.update({prefix + ref_name(k): v for k, v in conn.state_dict().items()})
    return state


@pytest.mark.parametrize("layout, file", [
    ("dit", "ltx-2-19b-distilled.safetensors"), ("diffusers", "connectors/diffusion_pytorch_model.safetensors"),
])
def test_connector_loader_matches_jax(encoder_trees, tmp_path, layout, file):
    jcfg, tcfg, tree, model = encoder_trees
    (tmp_path / file).parent.mkdir(parents=True, exist_ok=True)
    save_safetensors(tmp_path / file, _connector_state(model, layout))
    jparams = jte.init_text_encoder_params(jax.random.key(5), jcfg, hidden_dim=GEMMA["hidden_size"],
                                           dtype=jnp.float32, init_gemma=False)
    n_ref = jtew.load_connector_weights(jparams, tmp_path, dtype=jnp.float32)
    fresh = tte.init_text_encoder_params(tcfg, torch.Generator().manual_seed(5), GEMMA["hidden_size"], device="cpu",
                                         dtype=torch.float32, language_model=model.language_model)
    n_got = ttew.load_connector_weights(fresh, tmp_path)
    assert n_got == n_ref == 1 + 2 * (2 * 14 + 1)  # 14 tensors a block, the registers, the extractor
    ours = jax_bridge.module_to_jax_tree(fresh, STACKED)
    ours.pop("language_model")
    _assert_trees_equal(ours, jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------------------------------
# LTX2TextEncoder: a snapshot with a tokenizer
# ---------------------------------------------------------------------------


def write_text_encoder_snapshot(root, model: tte.TextEncoderModel):
    """``root/text_encoder`` (Gemma shards, config.json, a tiny BPE tokenizer
    trained here) and ``root/connectors`` for ``model``."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel
    from tokenizers.trainers import BpeTrainer

    te = root / "text_encoder"
    _write_gemma(te, model.language_model)
    tok = Tokenizer(BPE(unk_token=None))
    tok.pre_tokenizer = ByteLevel(add_prefix_space=False)
    trainer = BpeTrainer(vocab_size=GEMMA["vocab_size"], special_tokens=["<pad>", "<bos>", "<eos>"],
                         initial_alphabet=ByteLevel.alphabet())
    tok.train_from_iterator(["a cat jumping over a fence in slow motion", "a red car at night, rain"], trainer)
    tok.save(str(te / "tokenizer.json"))
    (te / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<bos>", "eos_token": "<eos>",
        "pad_token": "<pad>", "clean_up_tokenization_spaces": False}))
    (root / "connectors").mkdir(parents=True, exist_ok=True)
    save_safetensors(root / "connectors" / "diffusion_pytorch_model.safetensors", _connector_state(model, "diffusers"))


@pytest.mark.parametrize("w8a8", [False, True])
def test_text_encoder_loads_tokenizes_and_encodes(encoder_trees, tmp_path, w8a8):
    jcfg, tcfg, tree, model = encoder_trees
    write_text_encoder_snapshot(tmp_path, model)
    enc = tte.LTX2TextEncoder.load(tmp_path, tmp_path, max_length=16, dtype=torch.float32, w8a8=w8a8, device="cpu")
    assert enc.gemma_config == tcfg
    ids, mask = enc.tokenize("a cat in the rain")
    assert ids.shape == mask.shape == (1, 16) and mask[0, 0] == 0 and mask[0, -1] == 1  # left-padded
    assert (ids[0, mask[0] == 0] == enc.tokenizer.pad_token_id).all()
    video, audio = enc.encode("a cat in the rain")
    assert video.shape == audio.shape == (1, 16, GEMMA["hidden_size"])
    jtree = jax.tree.map(jnp.asarray, tree)
    if w8a8:
        jtree = jint8.quantize_text_encoder_w8a8(jtree)
        assert isinstance(enc.model.language_model.layers[0].self_attn.q_proj, Int8Linear)
    rv, ra = jte.encode_tokens(jtree, jcfg, jnp.asarray(ids), jnp.asarray(mask), True)
    bar = 1e-3 if w8a8 else 5e-4
    assert _rel_l2(video.numpy(), np.asarray(rv)) <= bar and _rel_l2(audio.numpy(), np.asarray(ra)) <= bar


def test_text_encoder_load_needs_a_tokenizer(encoder_trees, tmp_path):
    _write_gemma(tmp_path / "text_encoder", encoder_trees[3].language_model)
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        tte.LTX2TextEncoder.load(tmp_path, tmp_path, device="cpu")
