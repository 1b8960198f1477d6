"""Tokenizer parity import path (reference:
ltx_core/text_encoders/gemma/tokenizer.py)."""

from __future__ import annotations

from pathlib import Path


class LTXVGemmaTokenizer:
    """Thin wrapper over the HF Gemma tokenizer used by the text encoder
    (reference: ltx_core/text_encoders/gemma/tokenizer.py; the encoder
    resolves the same tokenizer inside LTX2TextEncoder.load)."""

    def __init__(self, tokenizer_path):
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(
            str(Path(tokenizer_path)), trust_remote_code=True
        )

    def __call__(self, *args, **kwargs):
        return self.tokenizer(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.tokenizer, name)


__all__ = ["LTXVGemmaTokenizer"]
