"""Multimodal prompt encoding: parts -> (K+1, T) token matrices.

Numpy re-implementation of the reference ContentSequence
(fish_speech/content_sequence.py:24-324): text parts are
tokenized, VQ parts map codes arithmetically onto the contiguous semantic
token range (`code + semantic_begin_id`), and `encode_for_inference` packs the
(num_codebooks+1, T) prompt matrix the Dual-AR decoder consumes. Host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import numpy as np

from .tokenizer import IM_END_TOKEN, MODALITY_TOKENS


@dataclass
class TextPart:
    text: str | None = None
    tokens: list[int] | None = None
    cal_loss: bool = False
    type: str = "text"

    def __post_init__(self):
        if self.text is None and self.tokens is None:
            raise ValueError("Either text or tokens must be provided")


@dataclass
class VQPart:
    codes: np.ndarray  # (K, T) int
    cal_loss: bool = False
    type: str = "vq"

    def __post_init__(self):
        self.codes = np.asarray(self.codes)


@dataclass
class EncodedParts:
    tokens: np.ndarray                 # (T,) int64
    labels: np.ndarray                 # (T,) int64, -100 = ignore
    vq_mask_tokens: np.ndarray         # (T,) bool — VQ positions in tokens
    vq_mask_labels: np.ndarray         # (T,) bool — VQ positions in labels
    vq_parts: list[np.ndarray]         # list of (K, Ti)


@dataclass
class ContentSequence:
    parts: list = field(default_factory=list)
    modality: Literal["text", "voice", "interleave"] | None = None

    def __post_init__(self):
        if self.modality:
            first = self.parts[0] if self.parts else None
            already = (isinstance(first, TextPart) and first.text is not None
                       and first.text.startswith(MODALITY_TOKENS[self.modality]))
            if not already:
                self.parts = [TextPart(text=MODALITY_TOKENS[self.modality])] \
                    + list(self.parts)

    def append(self, part_or_parts, add_end: bool = False, speaker=None):
        parts = part_or_parts if isinstance(part_or_parts, list) else [part_or_parts]
        if speaker is not None:
            self.parts.append(TextPart(text=f"<|speaker:{speaker}|>"))
        self.parts.extend(parts)
        if add_end:
            self.parts.append(
                TextPart(text=IM_END_TOKEN, cal_loss=self.parts[-1].cal_loss))

    def encode(self, tokenizer, add_shift: bool = True,
               ignore_loss_tokens: list[str] = ()) -> EncodedParts:
        all_tokens, all_labels, vq_masks, vq_parts = [], [], [], []

        for part in self.parts:
            if isinstance(part, TextPart):
                toks = (part.tokens if part.tokens is not None
                        else tokenizer.encode(part.text))
                toks = np.asarray(toks, dtype=np.int64)
                vq_masks.append(np.zeros(len(toks), dtype=bool))
            elif isinstance(part, VQPart):
                codes = part.codes.astype(np.int64)
                toks = codes[0] + tokenizer.semantic_begin_id
                vq_parts.append(codes)
                vq_masks.append(np.ones(len(toks), dtype=bool))
            else:
                raise ValueError(f"Unsupported part type: {type(part)}")

            all_tokens.append(toks)
            if part.cal_loss:
                all_labels.append(toks.copy())
            else:
                all_labels.append(np.full(len(toks), -100, dtype=np.int64))

        tokens = np.concatenate(all_tokens) if all_tokens else np.zeros(0, np.int64)
        labels = np.concatenate(all_labels) if all_labels else np.zeros(0, np.int64)
        vq_mask = np.concatenate(vq_masks) if vq_masks else np.zeros(0, bool)

        vq_mask_tokens = vq_mask
        vq_mask_labels = vq_mask
        if add_shift and len(tokens) > 0:
            tokens = tokens[:-1]
            labels = labels[1:]
            vq_mask_tokens = vq_mask_tokens[:-1]
            vq_mask_labels = vq_mask_labels[1:]

        for tok_str in ignore_loss_tokens:
            tid = tokenizer.get_token_id(tok_str)
            labels[labels == tid] = -100

        return EncodedParts(tokens=tokens, labels=labels,
                            vq_mask_tokens=vq_mask_tokens,
                            vq_mask_labels=vq_mask_labels, vq_parts=vq_parts)

    def visualize(self, tokenizer, merge_semantic_tokens: bool = True) -> str:
        """Color-coded token dump (ref content_sequence.py:326-403): green =
        no loss, blue = contributes to loss; returns the string (and prints)."""
        encoded = self.encode(tokenizer, add_shift=False)
        out = []
        run = 0
        run_label = None

        def flush():
            nonlocal run, run_label
            if run:
                color = "\033[94m" if run_label != -100 else "\033[92m"
                out.append(f"{color}[<|semantic|>x{run}]\033[0m")
                run = 0
                run_label = None

        for tok, lab in zip(encoded.tokens, encoded.labels):
            tok = int(tok)
            semantic = (tokenizer.semantic_begin_id <= tok
                        <= tokenizer.semantic_end_id)
            if merge_semantic_tokens and semantic and \
                    (run == 0 or run_label == int(lab)):
                run += 1
                run_label = int(lab)
                continue
            flush()
            val = tokenizer.decode([tok]) or f"<{tok}>"
            color = "\033[94m" if int(lab) != -100 else "\033[92m"
            out.append(f"{color}{val}\033[0m")
        flush()
        text = "".join(out)
        print(text)
        return text

    def encode_for_inference(self, tokenizer, num_codebooks: int) -> np.ndarray:
        """-> (num_codebooks+1, T) int32 prompt matrix
        (ref content_sequence.py:282-324)."""
        encoded = self.encode(tokenizer, add_shift=False)
        t = len(encoded.tokens)
        values = np.zeros((num_codebooks + 1, t), dtype=np.int32)
        values[0] = encoded.tokens
        if encoded.vq_parts:
            all_codes = np.concatenate(encoded.vq_parts, axis=1)
            values[1:, encoded.vq_mask_tokens] = all_codes.astype(np.int32)
        return values
