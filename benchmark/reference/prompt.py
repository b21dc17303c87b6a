"""The prompt a text-to-speech request without a voice reference makes.

A frozen copy written for the benchmark: the chat framing of S2-Pro's
inference prompt over the byte-level tokenizer (UTF-8 bytes 0..255, then
the special tokens, 16 speaker tags and the semantic ids), as the
(K+1, T) token matrix the Dual-AR decoder reads: the tokens on row 0, zero
codes below.
"""

from __future__ import annotations

import re

import numpy as np

SPECIALS = ("<|endoftext|>", "<|pad|>", "<|im_start|>", "<|im_end|>",
            "<|phoneme_start|>", "<|phoneme_end|>", "<|text|>", "<|voice|>",
            "<|interleave|>", "<|audio_start|>", "<|audio_end|>",
            "<|audio_pad|>")
N_SPEAKERS = 16
SYSTEM = "convert the provided text to speech"


def ids(n_semantic: int = 4096) -> dict:
    """The special ids and the semantic range of the byte tokenizer."""
    out = {tok: 256 + i for i, tok in enumerate(SPECIALS)}
    begin = 256 + len(SPECIALS) + N_SPEAKERS
    out.update(semantic_begin_id=begin,
               semantic_end_id=begin + n_semantic - 1,
               vocab_size=begin + n_semantic)
    return out


def _tokens(text: str, table: dict) -> list[int]:
    out, pos = [], 0
    for m in re.finditer(r"<\|[a-zA-Z_]+\|>", text):
        out.extend(text[pos:m.start()].encode("utf-8"))
        out.append(table[m.group()])
        pos = m.end()
    out.extend(text[pos:].encode("utf-8"))
    return out


def encode(text: str, num_codebooks: int, n_semantic: int = 4096
           ) -> tuple[np.ndarray, int]:
    """(K+1, T) int32 prompt of one request, and the length of its system
    part (the prefix every such request shares)."""
    table = ids(n_semantic)
    system = f"<|im_start|>system\n{SYSTEM}<|im_end|>\n"
    rest = (f"<|im_start|>user\n{text}<|im_end|>\n"
            f"<|im_start|>assistant\n<|voice|>")
    head, tail = _tokens(system, table), _tokens(rest, table)
    out = np.zeros((num_codebooks + 1, len(head) + len(tail)), np.int32)
    out[0] = head + tail
    return out, len(head)
