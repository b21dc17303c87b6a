"""Tokenizers with a contiguous semantic-token range.

Mirrors the surface of the reference FishTokenizer
(fish_speech/tokenizer.py:55-129): `encode` parses special
tokens inline, `semantic_begin_id`/`semantic_end_id` expose the contiguous
`<|semantic:i|>` range the Dual-AR decoder relies on
(ref content_sequence.py:201-211).

Two implementations:
- HFTokenizer: wraps a HuggingFace tokenizer on disk (real checkpoints).
- ByteTokenizer: self-contained UTF-8 byte-level tokenizer with the same
  special-token inventory — used for tests, demos and data tooling when no HF
  asset is present. Host-side only; never in the jit hot path.
"""

from __future__ import annotations

import re
from pathlib import Path

EOS_TOKEN = "<|endoftext|>"
PAD_TOKEN = "<|pad|>"
IM_START_TOKEN = "<|im_start|>"
IM_END_TOKEN = "<|im_end|>"
PHONEME_START_TOKEN = "<|phoneme_start|>"
PHONEME_END_TOKEN = "<|phoneme_end|>"

MODALITY_TEXT_TOKEN = "<|text|>"
MODALITY_VOICE_TOKEN = "<|voice|>"
MODALITY_INTERLEAVE_TOKEN = "<|interleave|>"
AUDIO_START_TOKEN = "<|audio_start|>"
AUDIO_END_TOKEN = "<|audio_end|>"
AUDIO_EMBED_TOKEN = "<|audio_pad|>"

MODALITY_TOKENS = {
    "text": MODALITY_TEXT_TOKEN,
    "voice": MODALITY_VOICE_TOKEN,
    "interleave": MODALITY_INTERLEAVE_TOKEN,
}

SEMANTIC_TOKEN_TEMPLATE = "<|semantic:{i}|>"

BASE_SPECIAL_TOKENS = [
    EOS_TOKEN,
    PAD_TOKEN,
    IM_START_TOKEN,
    IM_END_TOKEN,
    PHONEME_START_TOKEN,
    PHONEME_END_TOKEN,
    MODALITY_TEXT_TOKEN,
    MODALITY_VOICE_TOKEN,
    MODALITY_INTERLEAVE_TOKEN,
    AUDIO_START_TOKEN,
    AUDIO_END_TOKEN,
    AUDIO_EMBED_TOKEN,
]

ALL_SPECIAL_TOKENS = BASE_SPECIAL_TOKENS + [
    SEMANTIC_TOKEN_TEMPLATE.format(i=i) for i in range(4096)
]

_SPECIAL_RE = re.compile(r"<\|[a-zA-Z_]+(?::\d+)?\|>")


class ByteTokenizer:
    """UTF-8 bytes + special tokens; semantic ids contiguous at the end.

    Layout: [0..255] raw bytes, then base specials, then speaker tags
    <|speaker:0..15|>, then <|semantic:0..N-1|>.
    """

    def __init__(self, n_semantic: int = 4096, n_speakers: int = 16):
        self.n_semantic = n_semantic
        self._token_to_id: dict[str, int] = {}
        next_id = 256
        for tok in BASE_SPECIAL_TOKENS:
            self._token_to_id[tok] = next_id
            next_id += 1
        for i in range(n_speakers):
            self._token_to_id[f"<|speaker:{i}|>"] = next_id
            next_id += 1
        self.semantic_begin_id = next_id
        for i in range(n_semantic):
            self._token_to_id[SEMANTIC_TOKEN_TEMPLATE.format(i=i)] = next_id
            next_id += 1
        self.semantic_end_id = next_id - 1
        self.vocab_size = next_id
        self._id_to_token = {v: k for k, v in self._token_to_id.items()}

    @property
    def pad_token_id(self) -> int:
        return self._token_to_id[PAD_TOKEN]

    @property
    def eos_token_id(self) -> int:
        return self._token_to_id[EOS_TOKEN]

    def get_token_id(self, token: str) -> int:
        return self._token_to_id[token]

    def encode(self, text: str) -> list[int]:
        out: list[int] = []
        pos = 0
        for m in _SPECIAL_RE.finditer(text):
            if m.group() not in self._token_to_id:
                continue
            out.extend(text[pos:m.start()].encode("utf-8"))
            out.append(self._token_to_id[m.group()])
            pos = m.end()
        out.extend(text[pos:].encode("utf-8"))
        return out

    def decode(self, ids) -> str:
        if isinstance(ids, int):
            ids = [ids]
        parts: list[str] = []
        byte_buf = bytearray()
        for i in ids:
            i = int(i)
            if i < 256:
                byte_buf.append(i)
            else:
                if byte_buf:
                    parts.append(byte_buf.decode("utf-8", errors="replace"))
                    byte_buf = bytearray()
                parts.append(self._id_to_token.get(i, f"<{i}>"))
        if byte_buf:
            parts.append(byte_buf.decode("utf-8", errors="replace"))
        return "".join(parts)


class HFTokenizer:
    """HuggingFace-backed tokenizer (ref FishTokenizer, tokenizer.py:55-129)."""

    def __init__(self, model_path: str):
        from transformers import AutoTokenizer

        self._tokenizer = AutoTokenizer.from_pretrained(model_path)
        vocab = self._tokenizer.get_vocab()
        valid_ids = [
            vocab[SEMANTIC_TOKEN_TEMPLATE.format(i=i)]
            for i in range(4096)
            if SEMANTIC_TOKEN_TEMPLATE.format(i=i) in vocab
        ]
        if not valid_ids:
            self.semantic_begin_id = 0
            self.semantic_end_id = 0
        else:
            self.semantic_begin_id = min(valid_ids)
            self.semantic_end_id = max(valid_ids)

    @property
    def vocab_size(self) -> int:
        return self._tokenizer.vocab_size

    @property
    def pad_token_id(self):
        return self._tokenizer.pad_token_id

    @property
    def eos_token_id(self):
        return self._tokenizer.eos_token_id

    def get_token_id(self, token: str) -> int:
        return self._tokenizer.convert_tokens_to_ids(token)

    def encode(self, text: str, **kwargs) -> list[int]:
        import inspect

        sig = inspect.signature(self._tokenizer.encode)
        if "allowed_special" in sig.parameters and "allowed_special" not in kwargs:
            kwargs["allowed_special"] = "all"
        return self._tokenizer.encode(text, add_special_tokens=False, **kwargs)

    def decode(self, tokens, **kwargs) -> str:
        return self._tokenizer.decode(tokens, **kwargs)

    def save_pretrained(self, path: str):
        self._tokenizer.save_pretrained(path)


def load_tokenizer(path: str | Path | None):
    """HF tokenizer if assets exist at `path`, otherwise the byte fallback."""
    if path is not None:
        p = Path(path)
        if (p / "tokenizer.json").exists() or (p / "tokenizer_config.json").exists():
            return HFTokenizer(str(p))
    return ByteTokenizer()
