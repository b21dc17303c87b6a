"""Dual-AR transformer configuration.

Semantics mirror the reference dataclasses
(fish_speech/models/text2semantic/llama.py:27-194) expressed
as a single frozen, hashable dataclass usable as jit-static configuration.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace
from pathlib import Path


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclass(frozen=True)
class DualARConfig:
    # "dual_ar": AR fast head over codebooks; "naive": parallel codebook head
    # (ref llama.py NaiveTransformer, 613-656)
    model_type: str = "dual_ar"
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    dim: int = 4096
    intermediate_size: int | None = None
    n_local_heads: int = -1
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    tie_word_embeddings: bool = True
    attention_qkv_bias: bool = False
    attention_o_bias: bool = False
    attention_qk_norm: bool = False

    codebook_size: int = 160
    num_codebooks: int = 4

    semantic_begin_id: int = 0
    semantic_end_id: int = 0

    scale_codebook_embeddings: bool = False

    # fast (residual-codebook) transformer
    n_fast_layer: int = 4
    fast_dim: int | None = None
    fast_n_head: int | None = None
    fast_n_local_heads: int | None = None
    fast_head_dim: int | None = None
    fast_intermediate_size: int | None = None
    fast_attention_qkv_bias: bool | None = None
    fast_attention_qk_norm: bool | None = None
    fast_attention_o_bias: bool | None = None
    norm_fastlayer_input: bool = False

    initializer_range: float = 0.02

    # XLA schedule knob: unroll factor for the layer scans in the decode path
    # (weight prefetch overlap); no numerical effect
    scan_unroll: int = 1
    # separate unroll for the fast-head layer scan (its per-layer ops are
    # small, so schedule overlap matters more there; slow-stack unroll>1
    # measured strictly worse)
    fast_scan_unroll: int = 1
    # legacy flag (superseded by decode_stack_mode="unrolled"; kept for
    # checkpoint-config compatibility, otherwise ignored)
    unrolled_decode: bool = False
    # cached-decode layer-stack mode: "" = "carry" (cache carried through the
    # scan, in-place dynamic-layer-index updates: no double-buffering AND
    # fast compile — measured best everywhere), "unrolled", "scan"
    decode_stack_mode: str = ""
    # route T=1 cached attention through the Pallas decode kernel
    # (ops/attention.py) instead of the XLA einsum path
    use_pallas_attention: bool = False
    # with use_pallas_attention: >0 selects the block-of-rows stacked kernel
    # (that many batch rows per grid cell); 0 keeps the per-row kernel
    pallas_attn_block_rows: int = 0
    # block-of-rows kernel: run the score dot on the int8 MXU (q quantized
    # per row/head in-kernel; needs int8 KV cache)
    pallas_attn_int8_scores: bool = True
    # cache-seq positions per DMA chunk in the block-of-rows kernel
    pallas_attn_chunk: int = 128
    # single-grid-step streaming variant of the block-of-rows kernel
    pallas_attn_stream: bool = False
    # "native" (params dtype) or "int8": quantized KV cache halves the cache
    # bandwidth that dominates decode at large batch*seq
    kv_cache_dtype: str = "native"
    # "head" (L,B,Hkv,S,D) or "pos" (L,S,B,Hkv,D): position-major makes the
    # per-step cache write a contiguous tile-aligned slice (~30 us/layer
    # cheaper at 4B serving shapes). Decode requires the streaming Pallas
    # attention kernel; prefill pays one transposing read per layer.
    kv_cache_layout: str = "head"
    # fold the decode-step KV quantize+write into the stream kernel
    # (requires kv_cache_layout="pos" + int8 KV + stream attention;
    # opt-in: BENCH_KV_FOLD=1 in bench.py)
    kv_fold_write: bool = False
    # int8 activation x int8 weight MXU dots for quantized layers (2x MXU
    # rate, no weight-dequant pass; accuracy trade vs the reference's
    # weight-only PTQ — serving opt-in, see ops/quant.matmul_t)
    w8a8_matmuls: bool = False
    # python-unroll the K-1 fast-head sweeps in decode_one_token: static
    # codebook positions fold RoPE/mask to constants and let attention read
    # only the filled fast-cache prefix; bit-identical sampling stream
    unroll_fast_sweeps: bool = False
    # tensor-parallel shard count over the mesh `model` axis. >1: each rank
    # of a torch.distributed model group holds its slices of the weights
    # (parallel/mesh.py) and of the KV cache (Hkv / tp_shards heads, its
    # batch rows; position-major int8 scales its own s-major flat
    # (L, B, S*Hkv/tp), the single-device layout over its heads), calls
    # the kernels on them (parallel/tp.py: stream and blocks attention
    # head-local, the fused fast head batch-split) and runs the collectives
    # of parallel/collectives.py. Decode must run under
    # parallel.tp.decode_mesh(mesh) with mesh.model == tp_shards.
    tp_shards: int = 1

    def __post_init__(self):
        s = lambda k, v: object.__setattr__(self, k, v)
        if self.n_local_heads == -1:
            s("n_local_heads", self.n_head)
        if self.intermediate_size is None:
            hidden = int(2 * (4 * self.dim) / 3)
            s("intermediate_size", find_multiple(hidden, 256))
        if self.head_dim is None:
            s("head_dim", self.dim // self.n_head)
        if self.fast_dim is None:
            s("fast_dim", self.dim)
        if self.fast_n_head is None:
            s("fast_n_head", self.n_head)
        if self.fast_n_local_heads is None:
            s("fast_n_local_heads", self.n_local_heads)
        if self.fast_head_dim is None:
            s("fast_head_dim", self.head_dim)
        if self.fast_intermediate_size is None:
            s("fast_intermediate_size", self.intermediate_size)
        if self.fast_attention_qkv_bias is None:
            s("fast_attention_qkv_bias", self.attention_qkv_bias)
        if self.fast_attention_qk_norm is None:
            s("fast_attention_qk_norm", self.attention_qk_norm)
        if self.fast_attention_o_bias is None:
            s("fast_attention_o_bias", self.attention_o_bias)
        # Central layout/kernel pairing guard (shared by bench.py, the
        # serving CLIs and the tools): a position-major KV cache is only
        # readable in decode by the STREAMING block-of-rows kernel — the
        # per-row/blocks kernels index head-major (L,B,Hkv,S,D) and would
        # silently misread a (L,S,B,Hkv,D) buffer.
        if self.kv_cache_layout == "pos" and self.use_pallas_attention:
            if self.pallas_attn_block_rows <= 0 or not self.pallas_attn_stream:
                raise ValueError(
                    "kv_cache_layout='pos' requires the streaming decode "
                    "kernel: use pallas attention mode 'stream[N]' "
                    "(got block_rows=%d stream=%s)"
                    % (self.pallas_attn_block_rows, self.pallas_attn_stream))
        if self.tp_shards > 1 and self.n_local_heads % self.tp_shards != 0:
            raise ValueError(
                f"tp_shards={self.tp_shards} must divide n_local_heads="
                f"{self.n_local_heads} (KV heads are model-axis sharded)")

    # --- sub-config views -------------------------------------------------
    @property
    def slow_attn(self) -> "AttnDims":
        return AttnDims(self.dim, self.n_head, self.n_local_heads, self.head_dim,
                        self.attention_qkv_bias, self.attention_o_bias,
                        self.attention_qk_norm, self.w8a8_matmuls,
                        self.pallas_attn_block_rows,
                        self.pallas_attn_int8_scores,
                        self.pallas_attn_chunk,
                        self.pallas_attn_stream,
                        self.kv_cache_layout == "pos",
                        self.tp_shards,
                        self.kv_fold_write)

    @property
    def fast_attn(self) -> "AttnDims":
        return AttnDims(self.fast_dim, self.fast_n_head, self.fast_n_local_heads,
                        self.fast_head_dim, self.fast_attention_qkv_bias,
                        self.fast_attention_o_bias, self.fast_attention_qk_norm,
                        self.w8a8_matmuls, tp_shards=self.tp_shards)

    @staticmethod
    def from_json(path: str | Path) -> "DualARConfig":
        """Load a reference-format config.json (model_type naive/dual_ar/
        fish_qwen3_omni; ref llama.py:75-143)."""
        path = Path(path)
        if path.is_dir():
            path = path / "config.json"
        data = json.loads(path.read_text())
        mt = data.get("model_type", "dual_ar")
        if mt == "fish_qwen3_omni":
            tc, adc = data["text_config"], data["audio_decoder_config"]
            flat = dict(
                vocab_size=tc["vocab_size"], n_layer=tc["n_layer"],
                n_head=tc["n_head"], n_local_heads=tc.get("n_local_heads", -1),
                head_dim=tc.get("head_dim"), dim=tc["dim"],
                intermediate_size=tc.get("intermediate_size"),
                rope_base=tc.get("rope_base", 10000),
                norm_eps=tc.get("norm_eps", 1e-5),
                max_seq_len=tc.get("max_seq_len", 2048),
                tie_word_embeddings=tc.get("tie_word_embeddings", True),
                attention_qkv_bias=tc.get("attention_qkv_bias", False),
                attention_o_bias=tc.get("attention_o_bias", False),
                attention_qk_norm=tc.get("attention_qk_norm", False),
                semantic_begin_id=data.get("semantic_start_token_id", 0),
                semantic_end_id=data.get("semantic_end_token_id", 0),
                scale_codebook_embeddings=True,
                norm_fastlayer_input=True,
                codebook_size=adc["vocab_size"],
                num_codebooks=adc["num_codebooks"],
                n_fast_layer=adc["n_layer"],
                fast_dim=adc.get("dim"), fast_n_head=adc.get("n_head"),
                fast_n_local_heads=adc.get("n_local_heads"),
                fast_head_dim=adc.get("head_dim"),
                fast_intermediate_size=adc.get("intermediate_size"),
                fast_attention_qkv_bias=adc.get("attention_qkv_bias"),
                fast_attention_qk_norm=adc.get("attention_qk_norm"),
                fast_attention_o_bias=adc.get("attention_o_bias"),
            )
            flat = {k: v for k, v in flat.items() if v is not None}
            return DualARConfig(**flat)
        if mt not in ("naive", "dual_ar"):
            raise ValueError(f"Unknown model type: {mt}")
        import dataclasses as _dc
        valid = {f.name for f in _dc.fields(DualARConfig)}
        return DualARConfig(**{k: v for k, v in data.items() if k in valid})

    @property
    def is_naive(self) -> bool:
        return self.model_type == "naive"

    def with_semantic_range(self, begin: int, end: int) -> "DualARConfig":
        return replace(self, semantic_begin_id=begin, semantic_end_id=end)


@dataclass(frozen=True)
class AttnDims:
    dim: int
    n_head: int
    n_local_heads: int
    head_dim: int
    qkv_bias: bool
    o_bias: bool
    qk_norm: bool
    w8a8: bool = False
    # >0 routes the stacked-cache Pallas decode path through the
    # block-of-rows kernel with this many batch rows per grid cell
    pallas_block_rows: int = 0
    pallas_int8_scores: bool = True
    pallas_chunk: int = 128
    # route block-of-rows attention through the single-grid-step streaming
    # kernel (cross-block DMA pipelining)
    pallas_stream: bool = False
    kv_pos_major: bool = False
    # >1: the layer runs on the rank's heads and weight slices, its kernels
    # through the wrappers of parallel/tp.py; the cache holds the rank's
    # heads in the single-device layout (pos-major int8 flat scales
    # [b, s*(Hkv/tp) + h_local])
    tp_shards: int = 1
    # fold the decode-step KV quantize+write into the streaming kernel
    # (pos-major int8 single-shard decode only; ops/attention.py
    # pallas_decode_attention_stream_fold)
    kv_fold: bool = False


def apply_pallas_attn_mode(cfg: DualARConfig, mode: str,
                           chunk: int = 128) -> DualARConfig:
    """Apply a decode-attention mode string ("0" | "rows" |
    "blocks[N][-bf16]" | "stream[N]") to a config — shared by bench.py,
    tools/profile_decode.py and the serving CLIs so one spelling selects the
    same kernels everywhere."""
    import dataclasses

    if mode in ("0", ""):
        return dataclasses.replace(cfg, use_pallas_attention=False)
    rows, stream = 0, False
    if mode.startswith("blocks"):
        rows = int(mode.removeprefix("blocks").split("-")[0] or 16)
    elif mode.startswith("stream"):
        rows = int(mode.removeprefix("stream").split("-")[0] or 16)
        stream = True
    return dataclasses.replace(
        cfg, use_pallas_attention=True, pallas_attn_block_rows=rows,
        pallas_attn_int8_scores=not mode.endswith("-bf16"),
        pallas_attn_chunk=chunk, pallas_attn_stream=stream)


def s2_pro_lm_config(max_seq_len: int = 4096) -> DualARConfig:
    """Flagship S2-Pro-scale Dual-AR layout: 4B slow (Qwen3-4B-shaped text
    stack, ref README.md:118-122 'fish_qwen3_omni') + ~400M fast head over 10
    codebooks @ 4096 entries. The reference repo ships no config.json, so the
    text-stack dims follow the public Qwen3-4B layout the model card cites;
    semantic ids are injected from the tokenizer at load time
    (ref llama.py:499-509)."""
    return DualARConfig(
        vocab_size=151936,
        n_layer=36,
        n_head=32,
        n_local_heads=8,
        dim=2560,
        head_dim=128,
        intermediate_size=9728,
        rope_base=1000000.0,
        max_seq_len=max_seq_len,
        tie_word_embeddings=True,
        attention_qk_norm=True,
        codebook_size=4096,
        num_codebooks=10,
        scale_codebook_embeddings=True,
        norm_fastlayer_input=True,
        n_fast_layer=28,
        fast_dim=1024,
        fast_n_head=16,
        fast_n_local_heads=16,
        fast_head_dim=64,
        fast_intermediate_size=3072,
        fast_attention_qk_norm=False,
    )


def tiny_dual_ar_config(vocab_size: int = 256, semantic_begin: int = 32,
                        semantic_end: int = 95) -> DualARConfig:
    """Tiny model for parity tests: 2 slow layers + 2 fast layers, GQA."""
    return DualARConfig(
        vocab_size=vocab_size,
        n_layer=2,
        n_head=4,
        n_local_heads=2,
        dim=64,
        head_dim=16,
        intermediate_size=128,
        max_seq_len=128,
        codebook_size=64,
        num_codebooks=4,
        semantic_begin_id=semantic_begin,
        semantic_end_id=semantic_end,
        n_fast_layer=2,
        fast_dim=32,
        fast_n_head=2,
        fast_n_local_heads=2,
        fast_head_dim=16,
        fast_intermediate_size=64,
    )
