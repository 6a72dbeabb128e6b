"""The model of a configuration that names no ``model`` module: its sizes,
the weights the benchmark draws for it, and the port's ``TransformerLM``
built to them.

The file keeps the published ``config.json``'s key names.  The weights are
the benchmark's input, made on the device from the seed in a few large
calls, in the type they are served in, with the layout the port's
``TransformerLM`` reads (a leading layer axis on every layer leaf): a
normal draw scaled by fan-in^-0.5, norms at 1, the router in float32.
The reference draws the same weights again from the same seed; it never
reads the tensors handed to the program.

A model module exposes ``dims``, ``draw``, ``num_params``, ``build`` and
``moe_module``, as here; a configuration of another family names its own
under ``model`` (a path under ``perfbench/``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Dims:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int              # the SwiGLU's width, or one expert's
    vocab: int
    experts: int           # 0 for a dense feed-forward
    top_k: int
    eps: float
    rope_theta: float
    dtype: str

    @property
    def moe(self) -> bool:
        return self.experts > 0


def dims(config: dict) -> Dims:
    c = config
    return Dims(
        layers=int(c["num_hidden_layers"]), d_model=int(c["hidden_size"]),
        heads=int(c["num_attention_heads"]),
        kv_heads=int(c["num_key_value_heads"]), head_dim=int(c["head_dim"]),
        d_ff=int(c["intermediate_size"]), vocab=int(c["vocab_size"]),
        experts=int(c.get("num_local_experts", 0)),
        top_k=int(c.get("num_experts_per_tok", 0)),
        eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        dtype=c["dtype"])


# (path, shape, fan-in or 0 for a norm at 1, float32 leaf)
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], int, bool]


def layout(d: Dims) -> List[Leaf]:
    L, D, F = d.layers, d.d_model, d.d_ff
    q, kv = d.heads * d.head_dim, d.kv_heads * d.head_dim
    leaves: List[Leaf] = [
        (("embed", "table"), (d.vocab, D), D, False),
        (("layers", "ln1", "scale"), (L, D), 0, False),
        (("layers", "ln2", "scale"), (L, D), 0, False),
        (("layers", "attn", "wq"), (L, D, q), D, False),
        (("layers", "attn", "wk"), (L, D, kv), D, False),
        (("layers", "attn", "wv"), (L, D, kv), D, False),
        (("layers", "attn", "wo"), (L, q, D), q, False),
    ]
    if d.moe:
        E = d.experts
        leaves += [
            (("layers", "moe", "router"), (L, D, E), D, True),
            (("layers", "moe", "w_gate"), (L, E, D, F), D, False),
            (("layers", "moe", "w_up"), (L, E, D, F), D, False),
            (("layers", "moe", "w_down"), (L, E, F, D), F, False),
        ]
    else:
        leaves += [
            (("layers", "mlp", "w_gate"), (L, D, F), D, False),
            (("layers", "mlp", "w_up"), (L, D, F), D, False),
            (("layers", "mlp", "w_down"), (L, F, D), F, False),
        ]
    leaves.append((("final_norm", "scale"), (D,), 0, False))
    return leaves


def num_params(d: Dims) -> int:
    n = 0
    for _, shape, _, _ in layout(d):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def draw(d: Dims, seed: int, device) -> Dict:
    """The weights of ``seed``: one normal draw for every leaf in the
    served type, one in float32 for the float32 leaves, each cut into
    views and scaled in place."""
    dtype = DTYPES[d.dtype]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    leaves = layout(d)
    out: Dict = {}
    for wide in (False, True):
        part = [lf for lf in leaves if lf[3] == wide and lf[2]]
        total = sum(_numel(shape) for _, shape, _, _ in part)
        if not total:
            continue
        flat = torch.randn((total,), generator=gen, device=device,
                           dtype=torch.float32 if wide else dtype)
        at = 0
        for path, shape, fan_in, _ in part:
            n = _numel(shape)
            leaf = flat[at:at + n].view(shape)
            leaf.mul_(fan_in ** -0.5)
            _put(out, path, leaf)
            at += n
    for path, shape, fan_in, _ in leaves:
        if not fan_in:
            _put(out, path, torch.ones(shape, dtype=dtype, device=device))
    return out


def port_config(config: dict, d: Dims):
    """The port's ``ModelConfig`` of ``config["arch"]``, with every size
    the benchmark's file states."""
    from repro_torch.config import get_config

    base = get_config(config["arch"])
    att = dataclasses.replace(base.attention, num_heads=d.heads,
                              num_kv_heads=d.kv_heads, head_dim=d.head_dim,
                              rope_theta=d.rope_theta)
    kw = dict(num_layers=d.layers, d_model=d.d_model, d_ff=d.d_ff,
              vocab_size=d.vocab, attention=att, norm_eps=d.eps,
              dtype=d.dtype, tie_embeddings=True)
    if d.moe:
        kw["moe"] = dataclasses.replace(base.moe, num_experts=d.experts,
                                        top_k=d.top_k, d_expert=d.d_ff)
    return dataclasses.replace(base, **kw)


def build(config: dict, d: Dims, device):
    """``(the port's ModelConfig, the port's model)`` for ``config``."""
    from repro_torch.models.transformer import TransformerLM

    cfg = port_config(config, d)
    return cfg, TransformerLM(cfg, device=device)


def moe_module():
    """The port's module whose ``moe_apply`` the traced run puts inside
    the ``moe`` span."""
    from repro_torch.models import transformer

    return transformer


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _put(tree: Dict, path, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf
