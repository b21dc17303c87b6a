"""The training corpus: its protobuf messages and stream files, and the
datasets that turn them into (B, K+1, T) batches."""

from .braceexpand import braceexpand
from .semantic import (
    CODEBOOK_PAD_TOKEN_ID,
    InterleaveDataset,
    SemanticIterableDataset,
    TextDataCollator,
    data_loader,
    split_by_rank_worker,
)
from .stream import pack_pb_stream, read_pb_stream, split_pb_stream, write_pb_stream

__all__ = [
    "braceexpand", "CODEBOOK_PAD_TOKEN_ID", "InterleaveDataset",
    "SemanticIterableDataset", "TextDataCollator", "data_loader",
    "split_by_rank_worker", "pack_pb_stream", "read_pb_stream",
    "split_pb_stream", "write_pb_stream",
]
