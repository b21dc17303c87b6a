"""Semantic (text + VQ codes) training datasets.

Counterpart of `fish_speech_tpu/data/semantic.py`, a numpy
re-implementation of the reference dataset stack
(fish_speech/datasets/semantic.py): protobuf-stream corpora -> packed chat
sequences -> (B, K+1, T) batches, on the host. Samples are drawn from
Python's `random` module in the same calls and order as the JAX package's,
so the same `random.seed` gives the same samples and batches.

Files are strided over the dataloader's workers alone (ref
semantic.py:32-56 strides them over (rank, worker)): every rank of the
training CLI's (data, model) mesh reads the same global batch and keeps
its data rows (`parallel.mesh.shard_batch`), as JAX places the global
batch on P(data).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from random import Random
from typing import Iterator, Optional

import numpy as np

from ..text.clean import clean_text
from ..text.content import ContentSequence, TextPart, VQPart
from .braceexpand import braceexpand
from .protos import SampledData
from .stream import read_pb_stream

CODEBOOK_PAD_TOKEN_ID = 0


def split_by_rank_worker(files: list, worker_id: int = 0,
                         num_workers: int = 1) -> list:
    """Stride files over the dataloader's workers (ref semantic.py:32-56
    in a world of one process; see the module docstring)."""
    if len(files) < num_workers:
        files = files * (num_workers // max(len(files), 1) + 1)
    if num_workers > 1:
        files = files[worker_id::num_workers]
    return files


def expand_proto_files(proto_files: list[str]) -> list[Path]:
    expanded = []
    for filename in proto_files:
        for i in braceexpand(filename):
            p = Path(i)
            if p.is_file():
                expanded.append(p)
            elif p.is_dir():
                expanded.extend(p.rglob("*.proto"))
                expanded.extend(p.rglob("*.protos"))
            else:
                raise ValueError(f"{p} is not a file or directory")
    return sorted(expanded)


class SemanticIterableDataset:
    """Speaker-grouped packing dataset (ref semantic.py:59-283)."""

    def __init__(self, proto_files: list[str], tokenizer, seed: int = 42,
                 max_length: int = 1024, num_codebooks: Optional[int] = None,
                 causal: bool = True, skip_text_prob: float = 0.0,
                 worker_id: int = 0, num_workers: int = 1):
        self.proto_files = proto_files
        self.tokenizer = tokenizer
        self.seed = seed
        self.max_length = max_length
        self.num_codebooks = num_codebooks
        self.causal = causal
        self.skip_text_prob = skip_text_prob
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.groups = None

    def _init_groups(self):
        if self.groups is not None:
            return
        files = expand_proto_files(self.proto_files)
        Random(self.seed).shuffle(files)
        shard_files = split_by_rank_worker(files, self.worker_id, self.num_workers)
        self.groups = []
        for filename in shard_files:
            with open(filename, "rb") as f:
                self.groups.extend(read_pb_stream(f))
        Random(self.seed).shuffle(self.groups)
        self.group_weights = [len(g.sentences) for g in self.groups]

    def sample_data(self) -> SampledData:
        self._init_groups()
        num_samples = self.max_length // 20
        group = random.choices(self.groups, weights=self.group_weights, k=1)[0]
        if self.causal:
            if num_samples >= len(group.sentences):
                samples = list(group.sentences)
            else:
                begin = random.randint(0, len(group.sentences) - num_samples)
                samples = list(group.sentences[begin: begin + num_samples])
        else:
            samples = random.choices(group.sentences,
                                     k=min(num_samples, len(group.sentences)))
        return SampledData(source=group.source, name=group.name, samples=samples)

    def pack_sentences(self, sentences: list[str], semantics,
                       skip_text: bool = False):
        """-> (tokens (K+1, T), labels (K+1, T)) (ref semantic.py:185-250)."""
        seq = ContentSequence()
        seq.append(TextPart(text="Speak out the provided text."))

        cated = " ".join(sentences)
        if skip_text:
            cated = "<|skip_text|>"
        seq.append(TextPart(text=f"<|speaker:user|> {cated}"), add_end=True)

        vq_codes = np.asarray([list(x.values) for x in semantics[0]],
                              dtype=np.int32)
        vq_part = VQPart(codes=vq_codes, cal_loss=True)
        seq.append([TextPart(text="<|speaker:assistant|> <|voice|>",
                             cal_loss=True), vq_part], add_end=True)

        encoded = seq.encode(self.tokenizer, add_shift=True)
        num_codebooks = (vq_codes.shape[0] if self.num_codebooks is None
                         else self.num_codebooks)

        t = len(encoded.tokens)
        tokens = np.full((num_codebooks + 1, t), CODEBOOK_PAD_TOKEN_ID,
                         dtype=np.int64)
        tokens[0] = encoded.tokens
        all_vq = np.concatenate(encoded.vq_parts, axis=1)
        tokens[1:, encoded.vq_mask_tokens] = all_vq

        labels = np.full((num_codebooks + 1, t), -100, dtype=np.int64)
        labels[0] = encoded.labels
        labels[1:, encoded.vq_mask_labels] = all_vq
        labels[1:, -1:] = CODEBOOK_PAD_TOKEN_ID

        assert (tokens[1:, ~encoded.vq_mask_tokens] == CODEBOOK_PAD_TOKEN_ID).all()
        return tokens, labels

    def augment(self):
        response = self.sample_data()
        if len(response.samples) == 0:
            return None
        all_tokens, all_labels = [], []
        for sentence in response.samples:
            text = clean_text(random.choice(list(sentence.texts)))
            tokens, labels = self.pack_sentences(
                [text], [sentence.semantics],
                skip_text=random.random() < self.skip_text_prob)
            all_tokens.append(tokens)
            all_labels.append(labels)
        return {"tokens": np.concatenate(all_tokens, axis=1),
                "labels": np.concatenate(all_labels, axis=1)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            item = self.augment()
            if item is not None:
                yield item


class InterleaveDataset:
    """Probability-mixed iterable datasets (ref semantic.py:464-491)."""

    def __init__(self, datasets: list, probabilities: list[float],
                 seed: int = 42):
        self.datasets = datasets
        self.probabilities = probabilities
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        iters = [iter(d) for d in self.datasets]
        while True:
            idx = rng.choice(len(self.datasets), p=self.probabilities)
            try:
                yield next(iters[idx])
            except StopIteration:
                iters[idx] = iter(self.datasets[idx])
                yield next(iters[idx])


@dataclass
class TextDataCollator:
    """Pad/truncate to (B, K+1, T) numpy batches (ref semantic.py:494-565).

    attention_masks is True at PAD positions (the reference's and
    `forward_train`'s key_padding_mask convention).
    """

    tokenizer: object
    max_length: int = 1024

    def __call__(self, examples: list[dict]) -> dict:
        max_len = min(max(e["tokens"].shape[1] for e in examples),
                      self.max_length)
        pad_id = self.tokenizer.pad_token_id or 0

        tokens, masks, labels = [], [], []
        for e in examples:
            tk = e["tokens"][:, :max_len]
            lb = e["labels"][:, :max_len]
            t = tk.shape[1]
            mask = np.ones(max_len, dtype=bool)
            mask[:t] = False
            if t < max_len:
                tk = np.pad(tk, ((0, 0), (0, max_len - t)),
                            constant_values=pad_id)
                tk[1:, t:] = CODEBOOK_PAD_TOKEN_ID
                lb = np.pad(lb, ((0, 0), (0, max_len - t)),
                            constant_values=-100)
            tokens.append(tk)
            masks.append(mask)
            labels.append(lb)

        return {
            "inputs": np.stack(tokens).astype(np.int32),
            "attention_masks": np.stack(masks),
            "labels": np.stack(labels).astype(np.int32),
        }


def data_loader(dataset, collator: TextDataCollator, batch_size: int):
    """Simple batching loop over an iterable dataset -> collated batch
    dicts (`train.TrainBatch.from_numpy` puts one on the device)."""
    it = iter(dataset)
    while True:
        yield collator([next(it) for _ in range(batch_size)])
