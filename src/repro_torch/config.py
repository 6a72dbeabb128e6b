"""Configuration for the port: models, attention, serving and DLRM.

A copy of the fields of ``repro.config`` that the port reads, with the same
names and defaults, so configs and ``ServeConfig``s translate one to one.
Configs register under their ``--arch`` id via :func:`register`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"
RECSYS = "recsys"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (token-choice top-k, capacity-based)."""

    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # shared dense expert, as granite's / qwen-moe's (0 disables)
    d_shared_expert: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD sub-config (used by zamba2)."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV6 "Finch" sub-config: data-dependent decay time mix."""

    head_size: int = 64
    decay_lora: int = 64          # low-rank dim of the data-dependent decay
    token_shift: bool = True


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture: the reference's fields for the dense, MoE,
    SSM (rwkv6), hybrid (zamba2), audio (whisper) and VLM (internvl2)
    families."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # hybrid (zamba2): one attention block, shared across the stack, runs
    # before every group of ``hybrid_attn_every`` layers
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper): encoder depth; num_layers is decoder depth
    encoder_layers: int = 0
    encoder_seq: int = 0           # fixed encoder sequence (audio frames)
    # VLM: number of vision-stub embeddings prepended (internvl)
    vision_tokens: int = 0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"              # silu (swiglu) | gelu
    dtype: str = "bfloat16"
    source: str = ""

    def _attn_params(self) -> int:
        d, a = self.d_model, self.attention
        return (d * a.num_heads * a.head_dim               # q
                + 2 * d * a.num_kv_heads * a.head_dim      # k, v
                + a.num_heads * a.head_dim * d)            # o

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as
        ``repro.config.ModelConfig.num_params`` counts it for every
        family."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        emb = V * d
        head = 0 if self.tie_embeddings else V * d
        per_layer = 0
        if self.family in (DENSE, MOE, VLM, AUDIO):
            per_layer += self._attn_params()
            if self.moe is not None:
                m = self.moe
                per_layer += d * m.num_experts                  # router
                per_layer += m.num_experts * 3 * d * m.d_expert
                if m.d_shared_expert:
                    per_layer += 3 * d * m.d_shared_expert
            else:
                per_layer += 3 * d * self.d_ff                  # swiglu
            per_layer += 2 * d                                  # norms
        elif self.family == SSM:                                # rwkv6
            per_layer += 4 * d * d               # r, k, v, o (time mix)
            per_layer += d * self.d_ff + self.d_ff * d + d * d  # channel mix
            per_layer += 2 * d
        elif self.family == HYBRID:       # zamba2: mamba2 + shared attention
            s = self.ssm
            d_inner = s.expand * d
            per_layer += d * (2 * d_inner + 2 * s.d_state
                              + d_inner // s.head_dim)
            per_layer += d_inner * d
            per_layer += 2 * d
            shared_attn = self._attn_params() + 3 * d * self.d_ff
            return emb + head + L * per_layer + shared_attn
        total = emb + head + L * per_layer
        if self.encoder_layers:   # whisper encoder (self-attn + gelu mlp)
            enc_layer = self._attn_params() + 2 * d * self.d_ff + 2 * d
            # the decoder's cross-attention: one more attention block a layer
            total += self.encoder_layers * enc_layer
            total += self.num_layers * self._attn_params()
        return total

    def num_active_params(self) -> int:
        """Active (per-token) parameters: differs from :meth:`num_params`
        for MoE, where a token runs ``top_k`` of the experts."""
        if self.moe is None:
            return self.num_params()
        m = self.moe
        d, L = self.d_model, self.num_layers
        all_experts = L * m.num_experts * 3 * d * m.d_expert
        active_experts = L * m.top_k * 3 * d * m.d_expert
        return self.num_params() - all_experts + active_experts

    @property
    def depth_units(self) -> int:
        """Repeating-unit count (layers; groups for hybrid)."""
        if self.family == HYBRID:
            return self.num_layers // self.hybrid_attn_every
        return self.num_layers

    def with_depth(self, units: int) -> "ModelConfig":
        """Same width, ``units`` repeating units deep."""
        if self.family == HYBRID:
            return dataclasses.replace(
                self, num_layers=self.hybrid_attn_every * units)
        if self.encoder_layers:
            return dataclasses.replace(self, num_layers=units,
                                       encoder_layers=units)
        return dataclasses.replace(self, num_layers=units)

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """The same tiny config ``repro.config.ModelConfig.reduced`` makes."""
        small: Dict[str, Any] = dict(num_layers=2, d_model=64, d_ff=128,
                                     vocab_size=256)
        if self.attention is not None:
            ah = self.attention
            ratio = max(1, ah.num_heads // max(1, ah.num_kv_heads))
            kv = max(1, 4 // ratio)
            small["attention"] = dataclasses.replace(
                ah, num_heads=kv * ratio, num_kv_heads=kv, head_dim=16)
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_expert=32,
                d_shared_expert=32 if self.moe.d_shared_expert else 0)
        if self.ssm is not None:
            small["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk_size=16)
        if self.rwkv is not None:
            small["rwkv"] = dataclasses.replace(self.rwkv, head_size=16,
                                                decay_lora=8)
        if self.encoder_layers:
            small["encoder_layers"] = 2
            small["encoder_seq"] = 16
        if self.vision_tokens:
            small["vision_tokens"] = 8
        if self.hybrid_attn_every:
            small["hybrid_attn_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ParallelConfig:
    """How a step is laid out on the mesh (``repro.config.ParallelConfig``:
    the same names and defaults).  The serving engine reads
    ``model_axis``, the mesh axis it shards params and the KV pool over;
    the other fields are the training half's (ROADMAP A10)."""

    data_axis: Tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    fsdp_axis: Optional[str] = "data"       # param sharding over data (FSDP)
    expert_axis: Optional[str] = "model"    # expert-parallel axis
    remat: str = "full"                     # none | full | dots
    scan_layers: bool = True
    seq_shard_long: bool = True             # SP for long-context SSM scan
    compress_grads: bool = False            # int8 all-reduce w/ error feedback


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs; names and defaults as in ``repro.config.ServeConfig``.

    The port serves one device, with ``attn_impl="ragged"`` or
    ``"chunked"`` (``q_chunk`` and ``prefetch_depth`` tune the chunked
    kernel), the overlapped loop (``overlap``), speculative decoding
    (``spec``, up to ``spec_k`` drafts a request a step), the host KV tier
    (``host_blocks``) and, through ``repro_torch.serving.disagg``, split
    prefill / decode roles (``roles``).  ``devices > 1`` (or a mesh given
    to the engine) serves on a mesh of ranks over ``torch.distributed``
    (``repro_torch.launch.mesh``), sharded over ``parallel.model_axis``.
    ``trace`` is the launcher's replay trace path.

    The ragged kernel's tunables keep the reference's names (what each
    means on the card: ``core.attention_api``); 0 consults the measured
    table (``repro_torch.perf.autotune``), then the port's defaults, and a
    value > 0 wins.  ``sanitize`` turns on the runtime guards of
    ``repro_torch.analysis.sanitize``.
    """

    model: str
    kv_block_size: int = 128       # tokens per paged KV block
    max_blocks: int = 0            # 0 = derived from max_batch
    max_batch: int = 128
    prefill_chunk: int = 2048
    admission: str = "fcfs"
    preemption: str = "latest-arrival"
    eviction: str = "lru"
    spec: str = "off"              # off | ngram | draft-model
    spec_k: int = 4
    overlap: bool = False
    prefetch_depth: int = 0        # chunked kernel: page staging depth
    q_chunk: int = 16              # chunked kernel: lanes per query tile
    attn_impl: str = "ragged"      # ragged | chunked
    num_queries_per_block: int = 0   # ragged: query rows per tensor tile
    num_kv_pages_per_block: int = 0  # paged kernels: pages per decode split
    vmem_limit_bytes: int = 0        # paged kernels: shared-memory cap
    devices: int = 0
    roles: str = ""
    host_blocks: int = 0
    sanitize: bool = False
    trace: str = ""
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)


@dataclass(frozen=True)
class DLRMConfig:
    """DLRM-DCNv2 config (paper Table 3, RM1/RM2)."""

    name: str
    num_tables: int
    num_embeddings: int            # rows per table
    embedding_dim: int             # vector width (bytes swept in benchmarks)
    gathers_per_table: int         # pooling factor (bag size)
    bottom_mlp: Tuple[int, ...]
    top_mlp: Tuple[int, ...]
    cross_rank: int                # DCNv2 low-rank dim
    cross_layers: int
    dense_features: int = 13
    family: str = RECSYS

    def num_params(self) -> int:
        emb = self.num_tables * self.num_embeddings * self.embedding_dim
        mlp = 0
        dims = (self.dense_features,) + self.bottom_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            mlp += a * b + b
        # DCNv2 interaction input: concat([bottom_out, emb_1..emb_T])
        inter_in = self.bottom_mlp[-1] + self.num_tables * self.embedding_dim
        dims = (inter_in,) + self.top_mlp
        for a, b in zip(dims[:-1], dims[1:]):
            mlp += a * b + b
        cross = self.cross_layers * 2 * inter_in * self.cross_rank
        return emb + mlp + cross


@dataclass(frozen=True)
class ShapeCell:
    """One input shape of the dry run: ``global_batch`` sequences of
    ``seq_len`` tokens, a ``train``, ``prefill`` or ``decode`` step."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


# the reference's four cells per LM arch
SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, Any] = {}


def register(cfg: Any) -> Any:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> Any:
    _load_all()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; known: {sorted(_REGISTRY)}") from None


def list_configs():
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import repro_torch.configs  # noqa: F401  (import registers every config)
