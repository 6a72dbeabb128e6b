"""The training half on a mesh of ranks, as jobs a rank runs: the sharded
train step of the decoders and of DLRM, expert-parallel ``moe_apply``,
the pipeline and the compressed all-reduce.

Each ``*_job`` is a module-level function for
:func:`repro_torch.launch.mesh.run_ranks` (every rank runs it on its own
shards and returns its result, numpy arrays and floats); the tests run
them on the CPU over gloo ranks and hold them to the JAX package,
``chip_smoke.py`` phase 48 on the card, held to one device.

    from repro_torch.bench import sharded_train as st
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(st.train_job, 4, (st.TrainSpec(...), (2, 2), "cpu"))
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """One training run: ``arch`` (its full config, or ``.reduced()``
    with ``overrides`` when ``reduced``), in ``dtype``; ``batches`` the
    global batches (dicts of numpy arrays), a step each; params
    from ``params`` (numpy, the whole tree: each rank cuts its shards) or,
    when None, ``model.init(seed)``'s draw, a rank keeping its shards
    (``init(shard=)``).  AdamW with ``cosine_warmup(lr, warmup, total)``."""

    arch: str
    batches: Tuple[Dict[str, np.ndarray], ...]
    reduced: bool = True
    overrides: Tuple[Tuple[str, Any], ...] = ()
    dtype: str = "float32"
    params: Optional[Dict] = None
    seed: int = 0
    lr: Tuple[float, int, int] = (1e-3, 2, 10)
    model_kw: Tuple[Tuple[str, Any], ...] = ()
    remat: Any = False


def config(spec: TrainSpec):
    from repro_torch.config import get_config
    cfg = get_config(spec.arch)
    if spec.reduced:
        return cfg.reduced(dtype=spec.dtype, **dict(spec.overrides))
    return dataclasses.replace(cfg, dtype=spec.dtype, **dict(spec.overrides))


def build(spec: TrainSpec, device):
    from repro_torch.models.api import build_model
    cfg = config(spec)
    return cfg, build_model(cfg, device=device, remat=spec.remat,
                            **dict(spec.model_kw))


def _to_numpy(tree):
    from repro_torch import tree as tree_lib
    return tree_lib.map(lambda t: t.detach().float().cpu().numpy(), tree)


def _tensors(batch: Dict[str, np.ndarray], device) -> Dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _mesh(shape: Sequence[int]):
    from repro_torch.launch.mesh import make_smoke_mesh
    return make_smoke_mesh(*shape)


def _state(spec: TrainSpec, model, opt, mesh):
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.training.train_step import TrainState, init_state

    if spec.params is None:
        shard = model.shard_fn(mesh) if mesh is not None else None
        return init_state(model, spec.seed, opt, shard=shard)
    params = params_from_numpy(spec.params, device=model.device)
    if mesh is not None:
        params = model.shard_params(params, mesh)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device=model.device))


def halves_step(model, opt, lr_fn):
    """``make_train_step`` with each batch's gradient taken as the mean of
    its two halves' (the same function, the sums in another order): one
    device's own spread under a re-association, the control a mesh's
    distance from one device is read against."""
    from repro_torch import tree as tree_lib
    from repro_torch.optim.optimizer import apply_updates
    from repro_torch.training.train_step import TrainState, loss_and_grads

    def step(state, batch):
        n = next(iter(batch.values())).shape[0] // 2
        out = [loss_and_grads(model.loss, state.params,
                              {k: v[i * n:(i + 1) * n]
                               for k, v in batch.items()})
               for i in range(2)]
        (ga, structure), (gb, _) = (tree_lib.flatten(g) for _, g in out)
        grads = tree_lib.unflatten(structure, [0.5 * (a + b)
                                               for a, b in zip(ga, gb)])
        lr = lr_fn(state.step)
        updates, opt_state, gnorm = opt.update(grads, state.opt,
                                               state.params, lr)
        params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), {
            "loss": 0.5 * (out[0][0] + out[1][0]), "grad_norm": gnorm,
            "lr": lr}

    return step


def train_job(spec: TrainSpec, mesh_shape: Optional[Sequence[int]],
              device: str = "cpu", out_dir: Optional[str] = None,
              halves: bool = False) -> Dict:
    """AdamW steps of ``jit_train_step`` (a batch each) on this rank's
    ``(data, model)`` mesh (``mesh_shape``), or of ``make_train_step`` on
    one device (None; :func:`halves_step` with ``halves``):
    ``{"metrics": [{"loss", "grad_norm", "lr", "step_s"}, ...],
    "coords", "shards"}``, the params after the last step (numpy; with
    ``out_dir`` a ``torch.save`` file there instead, its path)."""
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.training.train_step import (
        abstract_state, jit_train_step, make_train_step)

    dev = torch.device(device)
    cfg, model = build(spec, dev)
    opt = adamw()
    lr_fn = cosine_warmup(*spec.lr)
    mesh = _mesh(mesh_shape) if mesh_shape is not None else None
    state = _state(spec, model, opt, mesh)
    if mesh is None:
        step = (halves_step if halves else make_train_step)(model, opt,
                                                             lr_fn)
    else:
        attn = getattr(cfg, "attention", None)
        rules = ShardingRules(mesh, head_dim=attn.head_dim if attn else None)
        shape = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
                 for k, v in spec.batches[0].items()}
        step = jit_train_step(model, opt, lr_fn, mesh, rules,
                              abstract_state(model, opt), shape)
    metrics = []
    for batch in spec.batches:
        t0 = time.perf_counter()
        state, m = step(state, _tensors(batch, dev))
        metrics.append({k: float(v) for k, v in m.items()})  # syncs
        metrics[-1]["step_s"] = time.perf_counter() - t0
    out = {"metrics": metrics,
           "coords": dict(mesh.coords) if mesh is not None else {}}
    if out_dir is None:
        out["shards"] = _to_numpy(state.params)
    else:
        rank = (torch.distributed.get_rank() if mesh is not None
                else "halves" if halves else "single")
        path = os.path.join(out_dir, f"params_{rank}.pt")
        torch.save({k: v for k, v in state.params.items()}, path)
        out["shards"] = path
    return out


def at_coords(mesh_coords: Dict, mesh_shape):
    """The coordinates of one rank of a ``(data, model)`` mesh of
    ``mesh_shape``, as the rules and ``shard_leaf`` read a mesh."""

    class _At:
        axis_names = ("data", "model")
        shape = dict(zip(("data", "model"), mesh_shape))
        coords = mesh_coords

        def size(self, a):
            return int(self.shape.get(a, 1))

        def axis_index(self, a):
            return int(self.coords.get(a, 0))

    return _At()


def expected_shard(model, full: Dict, mesh_coords: Dict, mesh_shape
                   ) -> Dict:
    """The slices of a whole params tree (numpy or tensors) that the rank
    at ``mesh_coords`` of a ``(data, model)`` mesh of ``mesh_shape``
    holds: the rules' specs cut as ``shard_leaf`` cuts them."""
    from repro_torch.distributed.sharding import map_with_path

    at = at_coords(mesh_coords, mesh_shape)
    rules = model.sharding_rules(at)

    def cut(path, x):
        t = torch.from_numpy(np.array(x))
        spec = rules.param_spec(tuple(path), tuple(t.shape))
        for d, axis in enumerate(spec):
            if axis is None:
                continue
            n, i = at.size(axis), at.axis_index(axis)
            step = t.shape[d] // n
            t = t.narrow(d, i * step, step)
        return t.numpy()

    return map_with_path(cut, full)


# ------------------------------------------------------------------ MoE EP
def _moe_shards(model, cfg, mesh, layer: Dict, requires_grad: bool = False
                ) -> Dict:
    """This rank's shards of one MoE layer (``layer``: numpy or tensors, the
    whole layer), cut by the rules' spec of the stacked leaf less its L
    dim; leaves of their own that require grad when ``requires_grad``."""
    from repro_torch.distributed.sharding import map_with_path, shard_leaf

    rules = model.sharding_rules(mesh)
    L = cfg.num_layers

    def cut(path, x):
        t = torch.as_tensor(np.ascontiguousarray(x) if isinstance(
            x, np.ndarray) else x).to(model.device)
        spec = rules.param_spec(("layers", "moe") + tuple(path),
                                (L,) + tuple(t.shape))[1:]
        t = shard_leaf(t.detach(), spec, mesh)
        return t.detach().clone().requires_grad_(True) if requires_grad \
            else t

    return map_with_path(cut, layer)


def moe_job(arch: str, overrides: Tuple, params_np: Dict, x_np: np.ndarray,
            mesh_shape: Sequence[int], groups: int,
            full_capacity: bool = False, device: str = "cpu") -> Dict:
    """Expert-parallel ``moe_apply`` of one layer on this rank's mesh: the
    layer's params (numpy, the whole layer; each rank cuts its shards by
    the rules) on x (the global batch (B, S, D); each rank takes its batch
    shard).  Returns ``{"out": this rank's batch shard's output, "aux",
    "coords", "dispatch": the layouts the call took}``."""
    from repro_torch.config import get_config
    from repro_torch.distributed.sharding import shard_leaf
    from repro_torch.layers import moe
    from repro_torch.models.api import build_model

    dev = torch.device(device)
    cfg = get_config(arch).reduced(dtype="float32", **dict(overrides))
    model = build_model(cfg, device=dev)
    mesh = _mesh(mesh_shape)
    tp = model.tensor_parallel(mesh)
    params = tp.gather_params({"moe": _moe_shards(model, cfg, mesh,
                                                  params_np)},
                              "layers")["moe"]
    x = torch.from_numpy(np.ascontiguousarray(x_np)).to(dev)
    x = shard_leaf(x, model.sharding_rules(mesh).batch_spec(tuple(x.shape)),
                   mesh)
    for k in moe.dispatch_counts:
        moe.dispatch_counts[k] = 0
    out, aux = moe.moe_apply(params, x, cfg.moe, shard=True, groups=groups,
                             full_capacity=full_capacity, tp=tp)
    return {"out": out.cpu().numpy(), "aux": float(aux),
            "coords": dict(mesh.coords),
            "dispatch": dict(moe.dispatch_counts)}


def moe_grads_job(arch: str, reduced: bool, batch: Tuple[int, int],
                  mesh_shape: Sequence[int], groups: int,
                  device: str = "cpu", seed: int = 0) -> Dict:
    """Expert-parallel ``moe_apply`` of one MoE layer of ``arch`` (float32,
    ``reduced`` or at full width) against one device, forward and backward,
    on this rank: the layer, x and w (``batch`` = (B, S) tokens) drawn from
    ``seed`` on the CPU; the loss ``sum(out * w) + aux`` on this rank's
    shards and batch shard, and on the whole layer and batch with no mesh
    (on this rank's device), its gradient cut as the rules cut.  Returns
    ``{"out_err": max |out - one device's rows|, "aux_rel", "grad_errs":
    {leaf: max |err| over the leaf's largest |value|}, "dispatch": the
    layouts the call took, "coords"}``."""
    from repro_torch import tree as tree_lib
    from repro_torch.distributed.sharding import map_with_path, shard_leaf
    from repro_torch.layers import moe
    from repro_torch.models.api import build_model

    dev = torch.device(device)
    cfg = config(TrainSpec(arch, (), reduced=reduced))
    model = build_model(cfg, device=dev)
    mesh = _mesh(mesh_shape)
    tp = model.tensor_parallel(mesh)
    batch_spec = model.sharding_rules(mesh).batch_spec
    gen = torch.Generator().manual_seed(seed)
    layer = moe.moe_init(gen, cfg.d_model, cfg.moe)
    x, w = (torch.randn((*batch, cfg.d_model), generator=gen).to(dev)
            for _ in range(2))

    def loss_of(params, x_, w_, **kw):
        out, aux = moe.moe_apply(params, x_, cfg.moe, groups=groups, **kw)
        return (out * w_).sum() + aux, out, aux

    whole = tree_lib.map(lambda t: t.to(dev).requires_grad_(True), layer)
    loss1, out1, aux1 = loss_of(whole, x, w)
    g1 = torch.autograd.grad(loss1, tree_lib.flatten(whole)[0])
    want = _moe_shards(model, cfg, mesh, tree_lib.unflatten(
        tree_lib.flatten(whole)[1], list(g1)))
    shards = _moe_shards(model, cfg, mesh, layer, requires_grad=True)
    params = tp.gather_params({"moe": shards}, "layers")["moe"]
    xs, ws = (shard_leaf(t, batch_spec(tuple(t.shape)), mesh) for t in (x, w))
    for k in moe.dispatch_counts:
        moe.dispatch_counts[k] = 0
    loss, out, aux = loss_of(params, xs, ws, shard=True, tp=tp)
    out, aux, aux1 = out.detach(), aux.detach(), aux1.detach()
    dispatch = dict(moe.dispatch_counts)
    leaves, structure = tree_lib.flatten(shards)
    got = tree_lib.unflatten(structure, list(torch.autograd.grad(loss,
                                                                 leaves)))
    rows = shard_leaf(out1.detach(), batch_spec(tuple(out1.shape)), mesh)
    errs = {}

    def err(path, a):               # the moe layer is a tree of dicts
        b = functools.reduce(lambda node, k: node[k], path, want)
        errs["/".join(path)] = float((a - b).abs().max() / b.abs().max())

    map_with_path(err, got)
    return {"out_err": float((out - rows).abs().max()),
            "aux_rel": float((aux - aux1).abs() / aux1.abs()),
            "grad_errs": errs, "dispatch": dispatch,
            "coords": dict(mesh.coords)}


# --------------------------------------------------------------------- DLRM
def dlrm_grads_job(arch: str, rows: int, params_np: Dict,
                   batch_np: Dict[str, np.ndarray],
                   mesh_shape: Sequence[int], device: str = "cpu") -> Dict:
    """DLRM's loss and gradients on this rank's mesh: the whole params
    (numpy; each rank cuts its shards) and the global batch (each rank
    its shard).  Returns ``{"loss", "grads" (this rank's shards, numpy),
    "coords", "launches"}``, the window kernels' launches on a card."""
    from repro_torch.config import get_config
    from repro_torch.core import embedding_api as emb
    from repro_torch.distributed.sharding import shard_leaf
    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.training.train_step import loss_and_grads

    dev = torch.device(device)
    cfg = dataclasses.replace(get_config(arch), num_embeddings=rows)
    model = build_model(cfg, device=dev)
    mesh = _mesh(mesh_shape)
    params = model.shard_params(params_from_numpy(params_np, device=dev),
                                mesh)
    rules = model.sharding_rules(mesh)
    batch = {k: shard_leaf(v, rules.batch_spec(tuple(v.shape)), mesh)
             for k, v in _tensors(batch_np, dev).items()}
    ops = (emb.embedding_bag_window, emb.embedding_bag_backward_window)
    for op in ops:
        op.launches = 0
    loss, grads = loss_and_grads(lambda p, b: model.loss(p, b, mesh=mesh),
                                 params, batch)
    return {"loss": float(loss), "grads": _to_numpy(grads),
            "coords": dict(mesh.coords),
            "launches": {op.name: op.launches for op in ops}}


# ----------------------------------------------------------------- pipeline
def pipeline_job(ws_np: np.ndarray, x_np: np.ndarray,
                 device: str = "cpu") -> np.ndarray:
    """The reference test's pipeline: stage s applies ``tanh(h @ ws[s])``
    over the ``("pp",)`` mesh of every rank; returns the (M, mb, D)
    outputs this rank holds."""
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(device)
    S = ws_np.shape[0]
    mesh = make_mesh((S,), ("pp",))
    w = torch.from_numpy(ws_np[mesh.axis_index("pp")]).to(dev)
    x = torch.from_numpy(x_np).to(dev)
    out = pipeline_forward(lambda w_, h: torch.tanh(h @ w_), w, x,
                           mesh=mesh, axis="pp", num_stages=S)
    return out.cpu().numpy()


# -------------------------------------------------------------- compression
def compression_job(g_np: np.ndarray, device: str = "cpu") -> Dict:
    """``compressed_psum`` of row r of ``g_np`` (one row a rank) over the
    ``("x",)`` mesh of every rank, residual 0: ``{"reduced",
    "residual"}`` (numpy)."""
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device(device)
    mesh = make_mesh((g_np.shape[0],), ("x",))
    g = torch.from_numpy(g_np[mesh.axis_index("x")]).to(dev)
    red, res = compressed_psum(g, torch.zeros_like(g), mesh, "x")
    return {"reduced": red.cpu().numpy(), "residual": res.cpu().numpy()}


def gather_rows(results: List[Dict], key: str = "out") -> np.ndarray:
    """The batch shards of the ranks of model index 0, in data order,
    stacked back into the global batch."""
    rows = sorted((r["coords"].get("data", 0), r[key]) for r in results
                  if r["coords"].get("model", 0) == 0)
    return np.concatenate([v for _, v in rows], axis=0)


# ------------------------------------------------------------- MoE serving
MOE_ARCH = "granite-moe-1b-a400m"


def moe_serve_job(params_np: Dict, mesh_on: bool, device: str = "cpu"
                  ) -> Dict:
    """Two cases of the sharded-engine sweep (``bench.sharded``: fcfs with
    the roomy pool, proposers off and ngram) on reduced float32
    :data:`MOE_ARCH` with ``params_np`` (the whole tree), on this
    process's serving mesh (``mesh_on``) or one device: ``{spec:
    {req_id: greedy tokens}}``."""
    from repro_torch.bench import sharded
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.bridge import params_from_numpy

    cfg = get_config(MOE_ARCH).reduced(dtype="float32")
    model = build_model(cfg, device=device)
    params = params_from_numpy(params_np, device=device)
    mesh = sharded._mesh(mesh_on)
    return {spec: sharded.run_case(model, params, cfg, spec,
                                   sharded.TRIPLES[0], sharded.NUM_BLOCKS[0],
                                   mesh, device)["outputs"]
            for spec in sharded.SPECS}


# ------------------------------------------------------- global norm, mesh
def norm_tree_full() -> Dict[str, np.ndarray]:
    """A two-leaf tree: ``a`` split over both axes of a (2, 2) mesh, ``b``
    replicated."""
    rng = np.random.default_rng(3)
    return {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def norm_job(mesh_shape: Sequence[int]) -> float:
    """``global_norm`` of this rank's shards of :func:`norm_tree_full`
    (``a`` split on dim 0 over ``data`` and dim 1 over ``model``)."""
    from repro_torch.distributed.sharding import shard_leaf
    from repro_torch.optim.optimizer import global_norm

    mesh = _mesh(mesh_shape)
    full = {k: torch.from_numpy(v) for k, v in norm_tree_full().items()}
    tree = {"a": shard_leaf(full["a"], ("data", "model"), mesh),
            "b": full["b"]}
    return float(global_norm(tree, mesh, [("data", "model"), ()]))


def mesh_job(mesh_shape: Sequence[int]) -> Dict:
    """This rank's coordinates and a SUM of the ranks' numbers over each
    axis."""
    from repro_torch.distributed import collectives

    mesh = _mesh(mesh_shape)
    r = float(torch.distributed.get_rank())
    return {"coords": dict(mesh.coords),
            "model_sum": float(collectives.all_reduce(
                torch.tensor([r]), mesh, "model")[0]),
            "data_sum": float(collectives.all_reduce(
                torch.tensor([r]), mesh, "data")[0])}
