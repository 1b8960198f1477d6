"""LTX-2 text encoder: Gemma-3 hidden states -> video and audio contexts.

Counterpart of mlx_video_tpu/models/ltx/text_encoder.py, plain PyTorch as it
is plain XLA there:

- Gemma-3 returns num_layers + 1 hidden states (models/gemma3.py);
- each state is normalised over the real (left-padded) tokens and the
  features, 8 (x - mean) / (max - min), in fp32, the states concatenated
  along the features and padded positions zeroed
  (:func:`norm_and_concat_hidden_states`);
- the feature extractor, one bias-free linear (49 * 3840 -> 3840 on the
  12B), maps them to the connectors' width;
- two connectors (video, audio), each: padded tokens replaced by tiled
  learnable registers with the real tokens moved to the front, then 2
  pre-norm blocks of attention (30 heads of 128, q/k RMSNorm over the whole
  inner width, split RoPE over absolute positions up to 4096) and a GELU
  feed-forward, and a final RMSNorm (:func:`connector_apply`).

:class:`LTX2TextEncoder` loads the weights (io/text_encoder_weights.py), in
bf16 or W8A8 (ops/int8.py:quantize_text_encoder_w8a8), tokenizes with the
snapshot's tokenizer (``transformers``, imported when a snapshot is loaded)
and encodes a prompt; :meth:`LTX2TextEncoder.shard` holds it sharded over a
mesh (parallel/sharding.py). Prompt enhancement (``enhance_t2v``, ``enhance_i2v``,
``enhance_negative``) chats with the same Gemma (models/gemma3.py:generate)
under the system prompts of ``prompts/`` (the port's copies of the JAX
package's files) and decodes the reply with the tokenizer.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlx_video_tpu_torch.models.gemma3 import Gemma3Model, Gemma3TextConfig, Weight, gemma3_hidden_states
from mlx_video_tpu_torch.models.gemma3 import generate as gemma_generate
from mlx_video_tpu_torch.ops.cross_attention import plain_attention
from mlx_video_tpu_torch.ops.linear import Linear, init_linear_, linear
from mlx_video_tpu_torch.ops.norms import rms_norm

PROMPTS_DIR = Path(__file__).parent / "prompts"


def load_system_prompt(name: str) -> str:
    path = PROMPTS_DIR / name
    if not path.exists():
        raise FileNotFoundError(f"System prompt not found: {path}")
    return path.read_text()


NUM_HEADS, HEAD_DIM = 30, 128  # the connectors' attention


# ---------------------------------------------------------------------------
# Hidden-state aggregation
# ---------------------------------------------------------------------------


def norm_and_concat_hidden_states(hidden_states, attention_mask: torch.Tensor,
                                  padding_side: str = "left") -> torch.Tensor:
    """Stack the states (B, T, D) x L, normalise each over its real tokens
    and features (mean and max - min, in fp32), scale by 8, concatenate along
    the features and zero padded positions: (B, T, D * L) fp32."""
    stacked = torch.stack(list(hidden_states), dim=-1).float()  # (B, T, D, L)
    b, t, d, num_layers = stacked.shape
    seq_lengths = attention_mask.sum(dim=-1)  # (B,)
    token_idx = torch.arange(t, device=stacked.device)[None, :]
    if padding_side == "right":
        mask = token_idx < seq_lengths[:, None]
    else:
        mask = token_idx >= (t - seq_lengths[:, None])
    mask4 = mask[:, :, None, None]

    eps = 1e-6
    masked = torch.where(mask4, stacked, 0.0)
    denom = (seq_lengths * d).reshape(b, 1, 1, 1).float()
    mean = masked.sum(dim=(1, 2), keepdim=True) / (denom + eps)
    x_min = torch.where(mask4, stacked, torch.inf).amin(dim=(1, 2), keepdim=True)
    x_max = torch.where(mask4, stacked, -torch.inf).amax(dim=(1, 2), keepdim=True)
    normed = 8.0 * (stacked - mean) / (x_max - x_min + eps)
    return torch.where(mask[:, :, None], normed.reshape(b, t, d * num_layers), 0.0)


class FeatureExtractor(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, device=None, dtype=None):
        super().__init__()
        self.aggregate_embed = Linear(input_dim, output_dim, bias=False, device=device, dtype=dtype)


def feature_extractor_apply(fe: FeatureExtractor, x: torch.Tensor) -> torch.Tensor:
    return linear(fe.aggregate_embed, x)


# ---------------------------------------------------------------------------
# Connector transformer
# ---------------------------------------------------------------------------


class ConnectorAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, device=None, dtype=None):
        super().__init__()
        inner, kw = num_heads * head_dim, dict(device=device, dtype=dtype)
        self.to_q, self.to_k, self.to_v = (Linear(dim, inner, **kw) for _ in range(3))
        self.to_out = Linear(inner, dim, **kw)
        self.q_norm, self.k_norm = Weight(inner, **kw), Weight(inner, **kw)


class ConnectorFeedForward(nn.Module):
    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.proj_in = Linear(dim, 4 * dim, device=device, dtype=dtype)
        self.proj_out = Linear(4 * dim, dim, device=device, dtype=dtype)


class ConnectorBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, device=None, dtype=None):
        super().__init__()
        self.attn1 = ConnectorAttention(dim, num_heads, head_dim, device=device, dtype=dtype)
        self.ff = ConnectorFeedForward(dim, device=device, dtype=dtype)


class Connector(nn.Module):
    def __init__(self, dim: int = 3840, num_heads: int = NUM_HEADS, head_dim: int = HEAD_DIM, num_layers: int = 2,
                 num_registers: int = 128, device=None, dtype=None):
        super().__init__()
        self.transformer_1d_blocks = nn.ModuleList(
            ConnectorBlock(dim, num_heads, head_dim, device=device, dtype=dtype) for _ in range(num_layers))
        self.learnable_registers = nn.Parameter(
            torch.zeros(num_registers, dim, device=device, dtype=dtype), requires_grad=False)


def _connector_rope(seq_len: int, num_heads: int, head_dim: int, max_pos: int = 4096, theta: float = 10000.0,
                    device=None):
    """Split-RoPE tables (1, H, T, D/2) fp32 over absolute positions, made in
    fp64 with numpy and rounded once, as the JAX function makes them."""
    num_indices = num_heads * head_dim // 2
    indices = np.power(theta, np.linspace(0.0, 1.0, num_indices, dtype=np.float64)) * (np.pi / 2)
    scaled = (np.arange(seq_len, dtype=np.float64) / max_pos) * 2 - 1
    freqs = scaled[:, None] * indices[None, :]  # (T, dim/2)

    def table(x):
        x = x.reshape(seq_len, num_heads, head_dim // 2).transpose(1, 0, 2)[None]
        return torch.from_numpy(np.ascontiguousarray(x.astype(np.float32))).to(device)

    return table(np.cos(freqs)), table(np.sin(freqs))


def _apply_split_rope_heads(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) half-dim rotation in fp32, back in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def connector_block_apply(block: ConnectorBlock, x: torch.Tensor, pe, num_heads: int, head_dim: int) -> torch.Tensor:
    """Pre-norm attention (q/k RMSNorm over the inner width, split RoPE,
    fp32 softmax) and a pre-norm GELU (erf) feed-forward, both residual."""
    b, t, _ = x.shape
    h = rms_norm(x)
    a = block.attn1
    q = rms_norm(linear(a.to_q, h), a.q_norm.weight)
    k = rms_norm(linear(a.to_k, h), a.k_norm.weight)
    v = linear(a.to_v, h)
    q, k = (_apply_split_rope_heads(z.reshape(b, t, num_heads, head_dim).transpose(1, 2), *pe).transpose(1, 2)
            for z in (q, k))
    out = plain_attention(q, k, v.reshape(b, t, num_heads, head_dim), None, head_dim**-0.5)
    x = x + linear(a.to_out, out.reshape(b, t, num_heads * head_dim))
    h = rms_norm(x)
    return x + linear(block.ff.proj_out, F.gelu(linear(block.ff.proj_in, h)))


def replace_padding_with_registers(hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                                   registers: torch.Tensor) -> torch.Tensor:
    """Move the real tokens of left-padded rows to the front and fill the
    tail with the registers tiled: output position j takes token
    pad_len + j while j < num_valid, else register j mod num_registers."""
    b, t, d = hidden_states.shape
    num_valid = attention_mask.to(torch.int64).sum(dim=-1)  # (B,)
    j = torch.arange(t, device=hidden_states.device)[None, :]
    src_idx = torch.clamp((t - num_valid)[:, None] + j, 0, t - 1)
    shifted = torch.gather(hidden_states, 1, src_idx[..., None].expand(b, t, d))
    reg_tiled = registers.repeat(-(-t // registers.shape[0]), 1)[:t].to(hidden_states.dtype)
    return torch.where((j < num_valid[:, None])[..., None], shifted, reg_tiled[None])


def connector_apply(connector: Connector, hidden_states: torch.Tensor, attention_mask: Optional[torch.Tensor],
                    num_heads: int = NUM_HEADS, head_dim: int = HEAD_DIM, max_pos: int = 4096) -> torch.Tensor:
    """Register replacement, the blocks, a final RMSNorm."""
    if attention_mask is not None:
        hidden_states = replace_padding_with_registers(hidden_states, attention_mask, connector.learnable_registers)
    pe = _connector_rope(hidden_states.shape[1], num_heads, head_dim, max_pos, device=hidden_states.device)
    for block in connector.transformer_1d_blocks:
        hidden_states = connector_block_apply(block, hidden_states, pe, num_heads, head_dim)
    return rms_norm(hidden_states)


# ---------------------------------------------------------------------------
# Full text encoder
# ---------------------------------------------------------------------------


class TextEncoderModel(nn.Module):
    """Gemma-3, the feature extractor and the two connectors, under the JAX
    tree's names (``language_model``, ``feature_extractor``,
    ``video_embeddings_connector``, ``audio_embeddings_connector``)."""

    def __init__(self, gemma_config: Gemma3TextConfig, hidden_dim: int = 3840, num_states: Optional[int] = None,
                 device=None, dtype=torch.bfloat16, language_model: Optional[Gemma3Model] = None):
        super().__init__()
        if num_states is None:
            num_states = gemma_config.num_hidden_layers + 1
        kw = dict(device=device, dtype=dtype)
        self.language_model = (language_model if language_model is not None
                               else Gemma3Model(gemma_config, **kw))
        self.feature_extractor = FeatureExtractor(hidden_dim * num_states, hidden_dim, **kw)
        self.video_embeddings_connector = Connector(hidden_dim, **kw)
        self.audio_embeddings_connector = Connector(hidden_dim, **kw)


@torch.no_grad()
def init_text_encoder_params(gemma_config: Gemma3TextConfig, generator: torch.Generator, hidden_dim: int = 3840,
                             device=None, dtype=torch.bfloat16, language_model: Optional[Gemma3Model] = None
                             ) -> TextEncoderModel:
    """Seeded feature extractor and connectors (the JAX init's distributions:
    linears U(-1/sqrt(in), 1/sqrt(in)) with zero bias, q/k norms one,
    registers zero), around ``language_model`` (or an uninitialised Gemma)."""
    model = TextEncoderModel(gemma_config, hidden_dim, device=device, dtype=dtype, language_model=language_model)
    for name, m in model.named_modules():
        if name.startswith("language_model"):
            continue
        if isinstance(m, Linear):
            init_linear_(m, generator)
        elif isinstance(m, Weight):
            m.weight.fill_(1.0)
    return model


def encode_tokens(
    model: TextEncoderModel,
    gemma_config: Gemma3TextConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    return_audio_embeddings: bool = True,
    num_heads: int = NUM_HEADS,
    head_dim: int = HEAD_DIM,
):
    """Token ids (B, T) and their left-padding mask -> (video embeddings,
    audio embeddings), each (B, T, hidden), or (video, mask) without audio.
    A sharded ``model`` (parallel/sharding.py:shard_params) runs its Gemma
    tensor-parallel and its feature extractor and connectors gathered
    whole; every rank returns the whole embeddings."""
    states = gemma3_hidden_states(model.language_model, gemma_config, input_ids, attention_mask)
    concat = norm_and_concat_hidden_states(states, attention_mask, padding_side="left")
    features = feature_extractor_apply(_whole(model, "feature_extractor"), concat.to(states[0].dtype))
    del states, concat
    video = connector_apply(_whole(model, "video_embeddings_connector"), features, attention_mask, num_heads, head_dim)
    if not return_audio_embeddings:
        return video, attention_mask
    audio = connector_apply(_whole(model, "audio_embeddings_connector"), features, attention_mask, num_heads, head_dim)
    return video, audio


def _whole(model: TextEncoderModel, name: str) -> nn.Module:
    """Submodule ``name``, gathered whole at use when the model is sharded
    (the connectors' 30 heads do not divide every ``tensor`` size)."""
    part = getattr(model, name)
    if getattr(model, "shard_specs", None) is None:
        return part
    from mlx_video_tpu_torch.parallel.sharding import gather

    return gather(part, model.shard_specs, model.mesh, prefix=f"{name}.")


class LTX2TextEncoder:
    """Tokenizer, Gemma-3 and the connectors: a prompt -> its embeddings."""

    def __init__(self, model: TextEncoderModel, gemma_config: Gemma3TextConfig, tokenizer=None,
                 max_length: int = 1024):
        self.model = model
        self.gemma_config = gemma_config
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def load(cls, model_path, text_encoder_path, max_length: int = 1024, dtype=torch.bfloat16,
             w8a8: bool = False, device="cuda") -> "LTX2TextEncoder":
        """Gemma from ``text_encoder_path`` (or its ``text_encoder/``), the
        feature extractor and connectors from ``model_path`` over a seeded
        init (as the JAX loader fills its init), onto ``device``; with ``w8a8`` the Gemma layers and the aggregation matmul
        become int8 in place, one layer at a time, so the bf16 stack is never
        held beside its codes. A snapshot without a tokenizer raises,
        naming the paths searched."""
        from mlx_video_tpu_torch.io.text_encoder_weights import load_connector_weights, load_gemma_weights

        te_path = Path(text_encoder_path)
        if (te_path / "text_encoder").is_dir():
            te_path = te_path / "text_encoder"
        gemma_config = Gemma3TextConfig.from_dict(json.loads((te_path / "config.json").read_text()))
        candidates = (te_path, Path(model_path) / "tokenizer")
        found = next((c for c in candidates if (c / "tokenizer.json").exists() or (c / "tokenizer.model").exists()),
                     None)
        if found is None:
            raise FileNotFoundError(
                "No tokenizer.json/tokenizer.model found for the Gemma text encoder; searched: "
                f"{[str(c) for c in candidates]}. Pass --text-encoder-path pointing at a snapshot that contains "
                "the tokenizer files, or use --embeddings to skip the text encoder."
            )
        language_model = load_gemma_weights(te_path, gemma_config, dtype=dtype, device=device)
        model = init_text_encoder_params(gemma_config, torch.Generator(device=device).manual_seed(0),
                                         gemma_config.hidden_size, device=device, dtype=dtype,
                                         language_model=language_model)
        load_connector_weights(model, Path(model_path))
        if w8a8:
            from mlx_video_tpu_torch.ops.int8 import quantize_text_encoder_w8a8

            quantize_text_encoder_w8a8(model)
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(str(found), trust_remote_code=True)
        tokenizer.padding_side = "left"
        return cls(model, gemma_config, tokenizer, max_length)

    def shard(self, mesh) -> "LTX2TextEncoder":
        """Hold the model as this rank's share on ``mesh``
        (parallel/sharding.py:shard_params, JAX's rules); returns self."""
        from mlx_video_tpu_torch.parallel.sharding import shard_params

        self.model = shard_params(self.model, mesh)
        return self

    def tokenize(self, prompt: str) -> Tuple[np.ndarray, np.ndarray]:
        if self.tokenizer is None:
            raise RuntimeError("Tokenizer not loaded")
        enc = self.tokenizer(prompt, return_tensors="np", max_length=self.max_length, truncation=True,
                             padding="max_length")
        return enc["input_ids"], enc["attention_mask"]

    @torch.no_grad()
    def encode(self, prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenize(prompt)
        device = self.model.language_model.embed_tokens.weight.device
        return encode_tokens(self.model, self.gemma_config, torch.from_numpy(ids).to(device),
                             torch.from_numpy(mask).to(device), True)

    __call__ = encode

    # -- prompt enhancement --------------------------------------------------

    def _chat(self, system_prompt: str, user_text: str, max_new_tokens: int, **kw) -> str:
        """One chat turn: the tokenizer's chat template with a generation
        prompt, greedy or sampled Gemma generation (``temperature``, default
        0.7; ``top_p``; ``seed`` for the draws, else seed 0) up to the
        tokenizer's eos or ``<end_of_turn>``, the reply decoded and stripped."""
        if self.tokenizer is None:
            raise RuntimeError("Tokenizer not loaded")
        messages = [{"role": "system", "content": system_prompt}, {"role": "user", "content": user_text}]
        ids = self.tokenizer.apply_chat_template(messages, add_generation_prompt=True, return_tensors="np")
        eos_ids = tuple(
            t for t in (self.tokenizer.eos_token_id, self.tokenizer.convert_tokens_to_ids("<end_of_turn>"))
            if isinstance(t, int) and t >= 0
        ) or (1,)
        device = self.model.language_model.embed_tokens.weight.device
        seed = kw.get("seed")
        tokens = gemma_generate(
            self.model.language_model, self.gemma_config, np.asarray(ids), max_new_tokens=max_new_tokens,
            temperature=kw.get("temperature", 0.7), top_p=kw.get("top_p", 1.0), eos_token_ids=eos_ids,
            generator=None if seed is None else torch.Generator(device=device).manual_seed(int(seed)),
        )
        return self.tokenizer.decode(tokens).strip()

    def enhance_t2v(self, prompt: str, max_new_tokens: int = 512, **kw) -> str:
        system = kw.pop("system_prompt", None) or load_system_prompt("gemma_t2v_system_prompt.txt")
        return self._chat(system, prompt, max_new_tokens, **kw) or prompt

    def enhance_i2v(self, prompt: str, image=None, max_new_tokens: int = 512, **kw) -> str:
        """The I2V system prompt; ``image`` is accepted as the JAX function
        accepts it and not read (the text-only Gemma sees no pixels)."""
        del image
        system = kw.pop("system_prompt", None) or load_system_prompt("gemma_i2v_system_prompt.txt")
        return self._chat(system, prompt, max_new_tokens, **kw) or prompt

    def enhance_negative(self, prompt: str, negative: str = "", max_new_tokens: int = 256, **kw) -> str:
        system = load_system_prompt("gemma_t2v_negative_system_prompt.txt")
        user = f"Prompt: {prompt}\nExisting negative prompt: {negative}"
        return self._chat(system, user, max_new_tokens, **kw) or negative
