"""Chat-message layer over ContentSequence
(ref fish_speech/conversation.py:19-103): system/user/assistant
messages framed as `<|im_start|>role\\n<|modality|> ... <|im_end|>\\n`."""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Literal

from .content import ContentSequence, TextPart
from .tokenizer import IM_END_TOKEN, IM_START_TOKEN, MODALITY_TOKENS


@dataclass(kw_only=True)
class Message:
    role: Literal["system", "user", "assistant"]
    parts: list = field(default_factory=list)
    add_im_start: bool = True
    add_im_end: bool = True
    cal_loss: bool = False
    modality: Literal["text", "voice", "interleave"] | None = None
    ignore_im_start_loss: bool = True


@dataclass
class Conversation:
    messages: list[Message] = field(default_factory=list)

    def append(self, message: Message):
        self.messages.append(message)

    def copy(self) -> "Conversation":
        return Conversation(copy.deepcopy(self.messages))

    def _build_content_sequence(self) -> ContentSequence:
        all_parts = []
        for message in self.messages:
            if message.add_im_start:
                modality_token = (MODALITY_TOKENS[message.modality]
                                  if message.modality else "")
                all_parts.append(TextPart(
                    text=f"{IM_START_TOKEN}{message.role}\n{modality_token}",
                    cal_loss=not message.ignore_im_start_loss))
            for part in message.parts:
                if part.cal_loss is False and message.cal_loss:
                    part = copy.deepcopy(part)
                    part.cal_loss = True
                all_parts.append(part)
            if message.add_im_end:
                all_parts.append(TextPart(text=IM_END_TOKEN + "\n",
                                          cal_loss=message.cal_loss))
        return ContentSequence(parts=all_parts, modality=None)

    def encode(self, tokenizer, add_shift: bool = True,
               ignore_loss_tokens: list[str] = ()):
        return self._build_content_sequence().encode(
            tokenizer, add_shift=add_shift, ignore_loss_tokens=ignore_loss_tokens)

    def encode_for_inference(self, tokenizer, num_codebooks: int):
        return self._build_content_sequence().encode_for_inference(
            tokenizer, num_codebooks=num_codebooks)
