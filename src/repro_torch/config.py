"""Configuration for the port: models, attention, serving and DLRM.

A copy of the fields of ``repro.config`` that the port reads, with the same
names and defaults, so configs and ``ServeConfig``s translate one to one.
Configs register under their ``--arch`` id via :func:`register`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

RECSYS = "recsys"

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
    """A single architecture (the dense decoder fields of the reference)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"              # silu (swiglu) | gelu
    dtype: str = "bfloat16"
    source: str = ""

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
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs; names and defaults as in ``repro.config.ServeConfig``.

    The port serves the draftless synchronous path, with
    ``attn_impl="ragged"`` or ``"chunked"`` (``q_chunk`` and
    ``prefetch_depth`` tune the chunked kernel); ``overlap``, ``spec``,
    ``devices > 1``, ``roles`` and ``host_blocks`` are refused by the
    engine.
    """

    model: str
    kv_block_size: int = 128       # tokens per paged KV block
    max_blocks: int = 0            # 0 = derived from max_batch
    max_batch: int = 128
    prefill_chunk: int = 2048
    admission: str = "fcfs"
    preemption: str = "latest-arrival"
    eviction: str = "lru"
    spec: str = "off"
    overlap: bool = False
    prefetch_depth: int = 0        # chunked kernel: page staging depth
    q_chunk: int = 16              # chunked kernel: lanes per query tile
    attn_impl: str = "ragged"      # ragged | chunked
    devices: int = 0
    roles: str = ""
    host_blocks: int = 0


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


def _load_all() -> None:
    import repro_torch.configs  # noqa: F401  (import registers every config)
