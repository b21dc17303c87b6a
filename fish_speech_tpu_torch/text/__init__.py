from .clean import clean_text
from .tokenizer import (
    ALL_SPECIAL_TOKENS,
    IM_END_TOKEN,
    IM_START_TOKEN,
    MODALITY_TOKENS,
    ByteTokenizer,
    HFTokenizer,
    load_tokenizer,
)
from .content import ContentSequence, EncodedParts, TextPart, VQPart
from .conversation import Conversation, Message

__all__ = [
    "clean_text", "ALL_SPECIAL_TOKENS", "IM_END_TOKEN", "IM_START_TOKEN",
    "MODALITY_TOKENS", "ByteTokenizer", "HFTokenizer", "load_tokenizer",
    "ContentSequence", "EncodedParts", "TextPart", "VQPart",
    "Conversation", "Message",
]
