"""The port's prompt enhancement against the JAX package, on the CPU, at the
narrow Gemma-3 of tests/test_torch_port_text_encoder.py (4 layers, sliding
and global, fp32, every leaf drawn from a seeded numpy generator): the
logits with and without KV caches, greedy generation, the top-p cutoff,
seeded sampling, the ``enhance_*`` chats and ``cli/enhance.py`` over a stub
tokenizer.

Bars, each with its reason:
- logits: relative L2 <= 1e-5 (the same fp32 products summed in another
  order; the cached path attends over the zeroed max_len buffers under
  -1e9, which softmax turns into exact zeros);
- greedy tokens, the top-p mask and the enhanced strings: equal (argmax of
  logits that agree far inside their gaps);
- sampling: the port draws from a ``torch.Generator`` (JAX's
  ``jax.random.categorical`` cannot be reproduced), so it is held to
  repeatability: the same seed gives the same tokens.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_text_encoder import _ids_and_mask, _rel_l2, encoder_trees  # noqa: F401 (fixture)

from mlx_video_tpu.cli import enhance as jenhance_cli
from mlx_video_tpu.models import gemma3 as jg
from mlx_video_tpu.models.ltx import text_encoder as jte
from mlx_video_tpu_torch.cli import enhance as tenhance_cli
from mlx_video_tpu_torch.models import gemma3 as tg
from mlx_video_tpu_torch.models.ltx import text_encoder as tte

torch.set_grad_enabled(False)


def _lm(encoder_trees):  # noqa: F811
    jcfg, tcfg, tree, model = encoder_trees
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree["language_model"]), model.language_model


@pytest.mark.parametrize("padded,last_only", [(False, False), (True, False), (True, True)])
def test_logits_without_cache_match_jax(encoder_trees, padded, last_only):  # noqa: F811
    jcfg, tcfg, params, lm = _lm(encoder_trees)
    ids, mask = _ids_and_mask(padded)
    ref, _ = jg.gemma3_logits(params, jcfg, jnp.asarray(ids), jnp.asarray(mask), last_only=last_only)
    got, caches = tg.gemma3_logits(lm, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                   last_only=last_only)
    assert caches is None and got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_l2(got.numpy(), ref) <= 1e-5
    chunked = tg.HEAD_CHUNK
    try:  # small vocabulary chunks, and the one fp32 copy generate() makes: the same products
        tg.HEAD_CHUNK = 7
        again, _ = tg.gemma3_logits(lm, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                                    last_only=last_only)
    finally:
        tg.HEAD_CHUNK = chunked
    copy, _ = tg.gemma3_logits(lm, tcfg, torch.from_numpy(ids).long(), torch.from_numpy(mask), last_only=last_only,
                               fp32_table=lm.embed_tokens.weight.float())
    assert _rel_l2(again.numpy(), got.numpy()) <= 1e-6 and _rel_l2(copy.numpy(), got.numpy()) <= 1e-6


def test_cached_logits_match_jax_and_the_uncached_prefix(encoder_trees):  # noqa: F811
    """A 5-token prefill then 4 single-token steps over max_len 12 caches,
    in both packages; each step's logits also against a no-cache forward
    over the same prefix (positions past the sliding window of 3)."""
    jcfg, tcfg, params, lm = _lm(encoder_trees)
    ids = np.random.default_rng(4).integers(0, 300, size=(1, 9)).astype(np.int32)
    jc = jg.init_kv_caches(jcfg, 1, 12, dtype=jnp.float32)
    tc = tg.init_kv_caches(tcfg, 1, 12, dtype=torch.float32)
    assert len(tc) == 4 and tc[0].k.shape == tuple(jc[0][0].shape) == (1, 2, 12, 16)
    mask = np.zeros((1, 12), np.int32)
    steps = [(0, 5)] + [(t, t + 1) for t in range(5, 9)]
    for start, end in steps:
        mask[:, start:end] = 1
        ref, jc = jg.gemma3_logits(params, jcfg, jnp.asarray(ids[:, start:end]), jnp.asarray(mask), jc,
                                   position_offset=start, last_only=True)
        got, tc = tg.gemma3_logits(lm, tcfg, torch.from_numpy(ids[:, start:end]).long(), torch.from_numpy(mask),
                                   tc, position_offset=start, last_only=True)
        assert tc[0].offset == int(jc[0][2]) == end
        assert _rel_l2(got.numpy(), ref) <= 1e-5
        full, _ = tg.gemma3_logits(lm, tcfg, torch.from_numpy(ids[:, :end]).long(), last_only=True)
        assert _rel_l2(got.numpy(), full.numpy()) <= 1e-5
        np.testing.assert_allclose(tc[1].k[:, :, :end].numpy(), np.asarray(jc[1][0])[:, :, :end], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("prompt_len,eos", [(6, (999,)), (4, None)])
def test_greedy_generation_matches_jax(encoder_trees, prompt_len, eos):  # noqa: F811
    """Greedy tokens equal, with no reachable eos (all max_new_tokens) and
    with an eos that generation meets (the first token JAX would emit
    twice is made eos)."""
    jcfg, tcfg, params, lm = _lm(encoder_trees)
    ids = np.random.default_rng(prompt_len).integers(0, 300, size=(1, prompt_len)).astype(np.int32)
    ref = jg.generate(params, jcfg, ids, max_new_tokens=6, temperature=0.0, eos_token_ids=eos or (999,))
    if eos is None:
        stop = next((t for i, t in enumerate(ref) if t in ref[:i]), ref[-1])
        eos = (stop,)
        ref = jg.generate(params, jcfg, ids, max_new_tokens=6, temperature=0.0, eos_token_ids=eos)
        assert len(ref) < 6
    got = tg.generate(lm, tcfg, ids, max_new_tokens=6, temperature=0.0, eos_token_ids=eos)
    assert got == ref and all(0 <= t < 300 for t in got)


@pytest.mark.parametrize("top_p", [0.3, 0.9, 0.999])
def test_top_p_mask_matches_jax(top_p):
    """The top-p cutoff on fixed logits against the JAX function's inline
    cutoff (models/gemma3.py generate)."""
    scaled = np.random.default_rng(7).normal(size=(1, 300)).astype(np.float32) * 3.0
    s = jnp.asarray(scaled)
    sorted_logits = jnp.sort(s, axis=-1)[:, ::-1]
    cum = jnp.cumsum(jax.nn.softmax(sorted_logits, axis=-1), axis=-1)
    cutoff = sorted_logits[0, jnp.sum(cum < top_p, axis=-1)[0]]
    ref = np.asarray(jnp.where(s < cutoff, -jnp.inf, s))
    got = tg.top_p_filter(torch.from_numpy(scaled), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    np.testing.assert_array_equal(got[np.isfinite(got)], ref[np.isfinite(ref)])
    assert 0 < np.isfinite(got).sum() < 300


def test_seeded_sampling_is_repeatable(encoder_trees):  # noqa: F811
    _, tcfg, _, lm = _lm(encoder_trees)
    ids = np.arange(3, 9, dtype=np.int64)[None]

    def draw(seed, **kw):
        return tg.generate(lm, tcfg, ids, max_new_tokens=8, temperature=50.0, eos_token_ids=(999,),
                           generator=torch.Generator().manual_seed(seed), **kw)

    a = draw(1)
    assert a == draw(1) and len(a) == 8
    assert any(draw(s) != a for s in (2, 3, 4))
    assert draw(5, top_p=0.5) == draw(5, top_p=0.5)
    assert tg.generate(lm, tcfg, ids, max_new_tokens=4, eos_token_ids=(999,)) == \
        tg.generate(lm, tcfg, ids, max_new_tokens=4, eos_token_ids=(999,))  # default: seed 0
    with pytest.raises(ValueError, match="single-prompt"):
        tg.generate(lm, tcfg, np.zeros((2, 3), np.int64), max_new_tokens=1)


class StubTokenizer:
    """Chat template and decode without ``transformers``: ids from the
    rendered chat's length and its ends, decode as 't<id>' words."""

    eos_token_id = 1

    def convert_tokens_to_ids(self, token):
        return 106 if token == "<end_of_turn>" else -1

    def apply_chat_template(self, messages, add_generation_prompt, return_tensors):
        assert add_generation_prompt and return_tensors == "np"
        text = "|".join(f"{m['role']}:{m['content']}" for m in messages)
        ids = [2, 3 + len(text) % 200] + [3 + ord(c) % 290 for c in text[:6] + text[-10:]]
        return np.asarray([ids], np.int64)

    def decode(self, tokens):
        return " ".join(f"t{t}" for t in tokens) + "  "


def _encoders(encoder_trees):  # noqa: F811
    jcfg, tcfg, tree, model = encoder_trees
    return (jte.LTX2TextEncoder(jax.tree.map(jnp.asarray, tree), jcfg, StubTokenizer()),
            tte.LTX2TextEncoder(model, tcfg, StubTokenizer()))


def test_system_prompts_are_the_jax_files():
    for name in ("gemma_t2v_system_prompt.txt", "gemma_i2v_system_prompt.txt",
                 "gemma_t2v_negative_system_prompt.txt"):
        assert (tte.PROMPTS_DIR / name).read_bytes() == (jte.PROMPTS_DIR / name).read_bytes()
        assert tte.load_system_prompt(name) == jte.load_system_prompt(name)
    with pytest.raises(FileNotFoundError, match="System prompt not found"):
        tte.load_system_prompt("missing.txt")


def test_enhance_chats_match_jax(encoder_trees):  # noqa: F811
    """enhance_t2v, enhance_i2v (an image given and not read) and
    enhance_negative, greedy, in both packages; an empty reply falls back to
    the prompt (or the negative)."""
    jenc, tenc = _encoders(encoder_trees)
    kw = dict(max_new_tokens=5, temperature=0.0)
    replies = []
    for call in (lambda e: e.enhance_t2v("a cat on a mat", **kw),
                 lambda e: e.enhance_i2v("a dog", image=np.zeros((4, 4, 3), np.uint8), **kw),
                 lambda e: e.enhance_negative("a cat", "blurry", **kw),
                 lambda e: e.enhance_t2v("a cat", system_prompt="Be brief.", **kw)):
        got, ref = call(tenc), call(jenc)
        assert got == ref
        replies.append(got)
    assert sum(r.startswith("t") for r in replies) >= 2  # generated words, not only fallbacks
    assert tenc.enhance_t2v("kept", max_new_tokens=0) == jenc.enhance_t2v("kept", max_new_tokens=0) == "kept"
    assert tenc.enhance_negative("x", "neg", max_new_tokens=0) == "neg"
    with pytest.raises(RuntimeError, match="Tokenizer not loaded"):
        tte.LTX2TextEncoder(tenc.model, tenc.gemma_config)._chat("s", "u", 1)


@pytest.mark.parametrize("argv", [["--mode", "t2v"], ["--mode", "i2v", "--json"]])
def test_enhance_cli_matches_jax(encoder_trees, tmp_path, monkeypatch, capsys, argv):  # noqa: F811
    """Both CLIs over the same encoder (their loaders patched to return it),
    greedy: the same printed line."""
    jenc, tenc = _encoders(encoder_trees)
    seen = []

    def loader(enc):
        def load(cls, model_path, te_path, **kw):
            seen.append((str(model_path), str(te_path), kw.get("device")))
            return enc
        return classmethod(load)

    monkeypatch.setattr(jte.LTX2TextEncoder, "load", loader(jenc))
    monkeypatch.setattr(tte.LTX2TextEncoder, "load", loader(tenc))
    args = ["--prompt", "a red fox", "--model-repo", str(tmp_path), "--temperature", "0", "--max-tokens", "4", *argv]
    jenhance_cli.main(args)
    ref = capsys.readouterr().out
    tenhance_cli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref and got.strip()
    if "--json" in argv:
        assert json.loads(got)["prompt"] == "a red fox"
    assert seen[1] == (str(tmp_path), str(tmp_path), torch.device("cpu"))
