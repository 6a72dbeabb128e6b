"""Sharding rules: param / batch / cache specs for every model family (port
of ``repro.distributed.sharding``), and the cutter that takes a rank's
shard from a full leaf.

A spec is a tuple with one entry per dimension: an axis name (the dim is
split over that mesh axis), a tuple of names (split over their product) or
None (replicated) — ``tuple(PartitionSpec)`` of the reference.  The rules
are the reference's, name and shape driven so one walker serves every
family:

* TP over ``model``: column weights (``_COL``) shard the output (last)
  dim, row weights (``_ROW``) the input dim, each only on whole heads when
  ``head_dim`` is set; the vocabulary (``table``) and DLRM's big table
  shard their rows;
* FSDP over ``data``: the other matmul dim;
* MoE: the expert dim over ``model``, the matrices FSDP on d_model;
* a dim the axis does not divide stays replicated.

:func:`shard_leaf` cuts this rank's block out of a full tensor (the model's
``shard_params`` and ``shard_fn`` apply it leaf by leaf), and
:func:`shard_shape` gives the block's shape without a tensor (a rank's
cache shard is allocated at that shape: ``init_decode_cache(mesh=)``);
:class:`TensorParallel` is what the sharded forward reads of the specs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


# weight-name classification (the reference's)
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "in_proj", "wr", "w1",
        "u", "router"}          # shard OUTPUT (last) dim over model
_ROW = {"wo", "w_down", "w_out", "out_proj", "wv_cm", "w2", "v"}

Spec = Tuple[Any, ...]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.size(a)
        return n
    return mesh.size(axis)


def _fits(dim: int, mesh, axis) -> bool:
    s = _axis_size(mesh, axis)
    return s > 1 and dim % s == 0


class ShardingRules:
    def __init__(self, mesh, *, fsdp_axis="data", model_axis="model",
                 fsdp_over_pod: bool = False,
                 head_dim: Optional[int] = None):
        """``head_dim``: attention head width, when the caller knows it;
        attention projections then shard only on whole heads (the
        reference's Megatron constraint).  ``None`` keeps the raw
        divisibility rule."""
        self.mesh = mesh
        names = mesh.axis_names
        self.model = model_axis if model_axis in names else None
        fsdp = fsdp_axis if fsdp_axis in names else None
        if fsdp_over_pod and "pod" in names and fsdp is not None:
            fsdp = ("pod", fsdp)
        self.fsdp = fsdp
        dp = tuple(a for a in ("pod", "data") if a in names)
        # one axis reads as its name (PartitionSpec's normal form)
        self.dp = (dp[0] if len(dp) == 1 else dp) or None
        self.head_dim = head_dim

    def _head_granular(self, d: int) -> bool:
        """Would sharding ``d`` over ``model`` keep whole heads per shard?"""
        if self.head_dim is None or self.head_dim <= 0:
            return True
        if d % self.head_dim != 0:
            return False
        return (d // self.head_dim) % _axis_size(self.mesh, self.model) == 0

    # ----------------------------------------------------------------- params
    def param_spec(self, path: Tuple[str, ...], shape) -> Spec:
        """Spec for one parameter given its tree path and shape."""
        name = path[-1]
        nd = len(shape)
        none = (None,) * nd

        def spec(*entries):
            # pad leading dims (layer stacking) with None
            return none[:nd - len(entries)] + tuple(entries)

        def m_if(d, heads=False):
            if not (self.model and _fits(d, self.mesh, self.model)):
                return None
            if heads and not self._head_granular(d):
                return None
            return self.model

        def f_if(d):
            return (self.fsdp if self.fsdp and _fits(d, self.mesh, self.fsdp)
                    else None)

        if name == "table":
            return (m_if(shape[0]), None)
        if _is_moe_path(path) and name in ("w_gate", "w_up"):
            E, D, _ = shape[-3:]
            return spec(m_if(E), f_if(D), None)
        if _is_moe_path(path) and name == "w_down":
            E, _, D = shape[-3:]
            return spec(m_if(E), None, f_if(D))
        if _is_moe_path(path) and name == "router":
            D, _ = shape[-2:]
            return spec(f_if(D), None)
        if nd >= 2 and name in _ROW:
            din, dout = shape[-2:]
            return spec(m_if(din, heads=name == "wo"), f_if(dout))
        if nd >= 2 and name in _COL:
            din, dout = shape[-2:]
            return spec(f_if(din),
                        m_if(dout, heads=name in ("wq", "wk", "wv")))
        if nd >= 2 and name == "conv_w":
            return spec(None, m_if(shape[-1]))
        if nd >= 2 and name == "w":              # dlrm mlp
            din, dout = shape[-2:]
            return spec(f_if(din), m_if(dout))
        if name == "embedding":                  # dlrm big table: rows
            return (m_if(shape[0]), None)
        return none                              # norms, biases, scalars

    def params_tree(self, params) -> Dict:
        """Spec tree matching a params (or meta-tensor) tree."""
        return map_with_path(lambda path, leaf: self.param_spec(
            path, tuple(leaf.shape)), params)

    # ------------------------------------------------------------- batch/cache
    def batch_spec(self, shape) -> Spec:
        """Batch arrays: dim0 over data axes when divisible."""
        b = shape[0]
        dp = (self.dp if self.dp and b % _axis_size(self.mesh, self.dp) == 0
              else None)
        return (dp,) + (None,) * (len(shape) - 1)

    def cache_spec(self, path: Tuple[str, ...], shape) -> Spec:
        """Decode caches. Contiguous KV (L,B,S,KV,HD): B->dp, S->model
        (sequence-sharded flash-decoding). States: B->dp, heads->model."""
        name = path[-1]
        nd = len(shape)

        def m_if(d):
            return (self.model if self.model and _fits(d, self.mesh,
                                                       self.model)
                    else None)

        def dp_if(d):
            return (self.dp if self.dp and d % _axis_size(self.mesh,
                                                          self.dp) == 0
                    else None)

        if name in ("k", "v", "xk", "xv") and nd == 5:    # (L,B,S,KV,HD)
            return (None, dp_if(shape[1]), m_if(shape[2]), None, None)
        if name == "seq_lens":
            return (dp_if(shape[0]),)
        if name == "S" and nd == 5:                        # rwkv (L,B,H,N,N)
            return (None, dp_if(shape[1]), m_if(shape[2]), None, None)
        if name in ("tm_shift", "cm_shift") and nd == 3:   # (L,B,D)
            return (None, dp_if(shape[1]), m_if(shape[2]))
        if name == "conv" and nd == 5:                     # (G,PG,B,K,convd)
            return (None, None, dp_if(shape[2]), None, m_if(shape[4]))
        if name == "h" and nd == 6:                        # (G,PG,B,H,hd,N)
            return (None, None, dp_if(shape[2]), m_if(shape[3]), None, None)
        return (None,) * nd

    def cache_tree(self, cache) -> Dict:
        """Spec tree matching a decode cache (tensors or meta tensors; the
        reference's walk over a cache)."""
        return map_with_path(lambda path, leaf: self.cache_spec(
            path, tuple(leaf.shape)), cache)


def shard_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """Rank ``mesh``'s block of the full tensor ``x`` under ``spec``: each
    split dim cut into ``size`` equal pieces, piece ``axis_index`` kept, in
    a tensor of its own (so the full one can be freed); ``x`` itself when
    nothing is split."""
    split = False
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        n, idx = _index(axis, mesh)        # row-major over the named axes
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} shards")
        step = x.shape[d] // n
        x = x.narrow(d, idx * step, step)
        split = True
    return x.clone(memory_format=torch.contiguous_format) if split else x


def _index(spec_entry, mesh) -> Tuple[int, int]:
    """(pieces, this rank's piece) of a dim split over ``spec_entry`` (an
    axis name or a tuple of them, row-major)."""
    names = (spec_entry if isinstance(spec_entry, (tuple, list))
             else (spec_entry,))
    n, idx = 1, 0
    for a in names:
        idx = idx * mesh.size(a) + mesh.axis_index(a)
        n *= mesh.size(a)
    return n, idx


def shard_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape`` under
    ``spec`` (what :func:`shard_leaf` would return)."""
    out = list(shape)
    for d, axis in enumerate(spec):
        if axis is not None:
            n, _ = _index(axis, mesh)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {n} shards")
            out[d] //= n
    return tuple(out)


def spec_leaves(specs) -> list:
    """The specs of a spec tree (:meth:`ShardingRules.params_tree`) in the
    order ``repro_torch.tree`` walks the params: dicts by sorted key,
    lists in order, each spec (a tuple) a leaf."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists, ``path`` the keys
    (list indices as strings) down to the leaf; None stays None."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _is_moe_path(path: Tuple[str, ...]) -> bool:
    # shared-expert weights are plain dense mats, not (E, ., .) stacks
    return "moe" in path and "shared" not in path


def _split_dim(spec: Spec, ndim: int, axis: Optional[str]) -> Optional[int]:
    """The dim of a tensor of ``ndim`` dims (a layer of a stacked leaf has
    fewer than its spec) that ``spec`` splits over ``axis``; None if none."""
    if axis is None:
        return None
    off = len(spec) - ndim
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, (tuple, list)) and axis in e):
            return d - off
    return None


class TensorParallel:
    """What a model's sharded paths read of a mesh and of its params'
    specs: which leaves ``model`` splits (:meth:`split`), this rank's
    block of a split dim (:meth:`bounds`), FSDP's gather of the leaves the
    data axis splits (:meth:`gather_params`), and the collectives of
    Megatron's layers over ``axis``: :meth:`enter` (f: a whole tensor into
    a split computation), :meth:`psum` (g: row-parallel partial products,
    summed in float32), :meth:`psum_exact` (a SUM where one rank holds
    each value and the others zeros), :meth:`gather` and
    :meth:`gather_last` (serving's column-parallel outputs and logits).
    Each is differentiable with its conjugate backward
    (``distributed.collectives``)."""

    def __init__(self, mesh, specs: Dict, axis: str = "model",
                 data_axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self.specs = specs
        self.size = mesh.size(axis)
        self.rank = mesh.axis_index(axis)
        self.data_axis = (data_axis if data_axis in mesh.axis_names
                          and mesh.size(data_axis) > 1 else None)

    def _spec(self, *path):
        node = self.specs
        for k in path:
            node = node[int(k)] if isinstance(node, list) else node[k]
        return node

    def split(self, *path) -> bool:
        """Whether the leaf at ``path`` is split over the axis."""
        return any(e == self.axis or (isinstance(e, (tuple, list))
                                      and self.axis in e)
                   for e in self._spec(*path))

    def bounds(self, dim: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's block of a dim of ``dim``."""
        step = dim // self.size
        return self.rank * step, (self.rank + 1) * step

    def gather_params(self, tree, *path):
        """``tree`` (this rank's shards of the params at ``path``: a layer of
        the stacked ``layers``, say) with every leaf the data axis splits
        gathered whole over it, in one collective; backward reduce-scatters
        their gradients and all-reduces the others' over the data axis
        (FSDP, and the data-parallel SUM).  ``tree`` itself without a data
        axis."""
        if self.data_axis is None:
            return tree
        return self._gather_tree(tree, path, self.data_axis, False)

    def whole(self, tree, *path):
        """``tree`` (params at ``path``, gathered over the data axis) with
        every leaf this axis splits gathered whole over it, in one
        collective, for a computation that every rank of the axis runs
        whole (backward keeps this rank's block of each gradient): the
        path of a layer whose cuts do not line up with any split of its
        computation.  ``tree`` itself when the axis has one rank."""
        if self.size == 1:
            return tree
        return self._gather_tree(tree, path, self.axis, True)

    def _gather_tree(self, tree, path, axis, replicated):
        leaves, dims = [], []

        def walk(node, spec):
            if isinstance(node, dict):
                for k in node:
                    walk(node[k], spec[k])
            elif isinstance(node, (list, tuple)):
                for v, sp in zip(node, spec):
                    walk(v, sp)
            elif node is not None:
                leaves.append(node)
                dims.append(_split_dim(spec, node.dim(), axis)
                            if node.is_floating_point() else None)

        walk(tree, self._spec(*path))
        from repro_torch.distributed import collectives
        floats = [i for i, t in enumerate(leaves) if t.is_floating_point()]
        whole = collectives.gather_shards([leaves[i] for i in floats],
                                          [dims[i] for i in floats],
                                          self.mesh, axis,
                                          replicated=replicated)
        for i, t in zip(floats, whole):
            leaves[i] = t
        it = iter(leaves)

        def build(node):
            if isinstance(node, dict):
                return {k: build(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v) for v in node)
            return None if node is None else next(it)

        return build(tree)

    def gather_split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of an activation split over the axis, whole,
        for a consumer that is itself split over the axis (each rank reads
        its own part of the whole: a norm over the whole width before a
        row-parallel product, a cut that does not line up with the next
        one): backward SUMs the ranks' partial gradients and keeps this
        rank's block (a reduce-scatter)."""
        from repro_torch.distributed import collectives
        return collectives.gather_shards([x], [dim % x.dim()], self.mesh,
                                         self.axis)[0]

    def gather_whole(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of an activation split over the axis, whole,
        for a consumer replicated over the axis (the residual stream):
        backward keeps this rank's block of the whole gradient."""
        from repro_torch.distributed import collectives
        return collectives.gather_replicated(x, self.mesh, self.axis, dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives
        return collectives.copy_to(x, self.mesh, self.axis)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        from repro_torch.distributed import collectives
        return collectives.all_gather(x, self.mesh, self.axis, dim)

    def gather_last(self, parts):
        """Each of ``parts`` (equal leading dims) gathered along its last
        dim, in ONE collective: the parts are concatenated, gathered and
        cut apart again (the same bits as a gather each)."""
        x = torch.cat(parts, dim=-1)
        g = self.gather(x).reshape(*x.shape[:-1], self.size, x.shape[-1])
        out, at = [], 0
        for p in parts:
            d = p.shape[-1]
            out.append(g[..., at:at + d].reshape(*x.shape[:-1],
                                                 self.size * d))
            at += d
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives
        return collectives.reduce_from(x, self.mesh, self.axis)

    def psum_exact(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.distributed import collectives
        return collectives.reduce_from(x, self.mesh, self.axis, f32=False)
