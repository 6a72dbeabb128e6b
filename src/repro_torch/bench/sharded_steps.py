"""The sharded serving steps (``serving.steps.jit_prefill_step`` /
``jit_serve_step``) of every LM family on a mesh of ranks, as jobs a rank
runs.

:func:`serve_job` is a module-level function for
:func:`repro_torch.launch.mesh.run_ranks` (every rank runs it on its own
shards and returns numpy arrays and floats), or for one device
(``mesh_shape`` None: ``make_prefill_step`` / ``make_serve_step``).  The
tests run it on the CPU over gloo ranks and hold it to the JAX package,
``chip_smoke.py`` phase 49 on the card, held to one device.  Training on
a mesh is ``bench.sharded_train.train_job``, for every family.

    from repro_torch.bench import sharded_steps as ss
    from repro_torch.launch.mesh import run_ranks
    ranks = run_ranks(ss.serve_job, 2, (ss.ServeSpec(...), (1, 2), "cpu"))
"""
from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One serving run: ``arch`` (its full config, or ``.reduced()`` with
    ``overrides`` when ``reduced``) in ``dtype``; ``prompts`` (B, P) int32
    go in through decode steps, one position a step, then ``new_tokens``
    greedy steps follow, over a cache of ``max_seq`` positions; the
    prefill step runs once on the whole prompts.  ``frames`` (B,
    encoder_seq, D): whisper's stub frames (``prefill_cross`` and the
    prefill's ``extra_embeds``).  Params from ``params`` (numpy, the whole
    tree: each rank cuts its shards) or, when None, ``model.init(seed)``'s
    draw, a rank keeping its shards (``init(shard=)``)."""

    arch: str
    prompts: np.ndarray
    new_tokens: int
    max_seq: int
    reduced: bool = True
    overrides: Tuple[Tuple[str, Any], ...] = ()
    dtype: str = "float32"
    params: Optional[Dict] = None
    seed: int = 0
    frames: Optional[np.ndarray] = None
    model_kw: Tuple[Tuple[str, Any], ...] = ()


def config(spec: ServeSpec):
    from repro_torch.config import get_config
    cfg = get_config(spec.arch)
    if spec.reduced:
        return cfg.reduced(dtype=spec.dtype, **dict(spec.overrides))
    return dataclasses.replace(cfg, dtype=spec.dtype, **dict(spec.overrides))


def build(spec: ServeSpec, device):
    from repro_torch.models.api import build_model
    cfg = config(spec)
    return cfg, build_model(cfg, device=device, remat=False,
                            **dict(spec.model_kw))


class _Recording:
    """The model with each ``decode_step``'s logits kept (this rank's
    batch shard's, on the host)."""

    def __init__(self, model):
        self.model = model
        self.logits = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *args, **kw):
        logits, cache = self.model.decode_step(*args, **kw)
        self.logits.append(logits.float().cpu())
        return logits, cache


def _params(spec: ServeSpec, model, mesh):
    from repro_torch.models.bridge import params_from_numpy

    if spec.params is None:
        shard = model.shard_fn(mesh) if mesh is not None else None
        return (model.init(spec.seed) if shard is None
                else model.init(spec.seed, shard=shard))
    params = params_from_numpy(spec.params, device=model.device)
    return model.shard_params(params, mesh) if mesh is not None else params


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_job(spec: ServeSpec, mesh_shape: Optional[Sequence[int]],
              device: str = "cpu", out_dir: Optional[str] = None) -> Dict:
    """The prefill step on the whole prompts, then the prompts through
    decode steps and ``new_tokens`` greedy steps, on this rank's ``(data,
    model)`` mesh (``mesh_shape``; ``jit_*_step``) or on one device
    (None).  Returns ``{"coords", "prefill" (B, V) the prefill's logits,
    "logits" (steps, B', V) each decode step's logits of this rank's
    batch shard, "streams" (B, new_tokens), "cache" this rank's cache
    shard after the last step (numpy), "step_s" the steps' seconds,
    "collectives" a step's collective calls, "seconds" by part}``; with
    ``out_dir``, "prefill", "logits" and "cache" go (as CPU tensors) to a
    ``torch.save`` file there and "arrays" is its path."""
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.serving import steps

    dev = torch.device(device)
    t0 = time.perf_counter()
    cfg, model = build(spec, dev)
    rec = _Recording(model)
    B, P = spec.prompts.shape
    mesh = make_smoke_mesh(*mesh_shape) if mesh_shape is not None else None
    params = _params(spec, model, mesh)
    _sync(dev)
    seconds = {"init": time.perf_counter() - t0}
    prompts = torch.from_numpy(np.ascontiguousarray(spec.prompts)).to(dev)
    batch = {"tokens": prompts}
    if spec.frames is not None:
        batch["extra_embeds"] = torch.from_numpy(
            np.ascontiguousarray(spec.frames)).to(dev).to(model.dtype)
    if mesh is None:
        prefill = torch.no_grad()(steps.make_prefill_step(model))
        serve = torch.no_grad()(steps.make_serve_step(rec))
        cache = model.init_decode_cache(B, spec.max_seq)
        frames = batch.get("extra_embeds")
    else:
        rules = model.sharding_rules(mesh)
        shape = model.init_abstract()
        prefill = steps.jit_prefill_step(model, mesh, rules, shape, batch)
        serve = steps.jit_serve_step(
            rec, mesh, rules, shape,
            steps.abstract_cache(model, B, spec.max_seq), prompts[:, 0])
        cache = model.init_decode_cache(B, spec.max_seq, mesh=mesh)
        frames = batch.get("extra_embeds")
        if frames is not None:
            from repro_torch.distributed.sharding import shard_leaf
            frames = shard_leaf(frames, rules.batch_spec(
                tuple(frames.shape)), mesh)
    t0 = time.perf_counter()
    pre = prefill(params, batch).float().cpu()
    if frames is not None:
        with torch.no_grad():
            model.prefill_cross(params, cache, frames,
                                **({"mesh": mesh} if mesh else {}))
    _sync(dev)
    seconds["prefill"] = time.perf_counter() - t0
    times, streams = [], []
    calls = collectives.calls.copy()
    nxt = None
    for t in range(P + spec.new_tokens - 1):
        tok = prompts[:, t] if t < P else nxt
        _sync(dev)
        t0 = time.perf_counter()
        nxt, cache = serve(params, cache, tok)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        if t >= P - 1:
            streams.append(nxt.cpu().numpy())
    steps_run = len(times)
    seconds["steps"] = sum(times)
    per_step = {k: (collectives.calls[k] - calls.get(k, 0)) / steps_run
                for k in collectives.calls}
    arrays = {"prefill": pre, "logits": torch.stack(rec.logits),
              "cache": {k: v.float().cpu() for k, v in cache.items()}}
    out = {"coords": dict(mesh.coords) if mesh is not None else {},
           "streams": np.stack(streams, axis=1), "step_s": times,
           "collectives": per_step, "seconds": seconds}
    if out_dir is None:
        return dict(out, prefill=pre.numpy(), logits=arrays["logits"].numpy(),
                    cache={k: v.numpy() for k, v in arrays["cache"].items()})
    t0 = time.perf_counter()
    rank = (torch.distributed.get_rank() if mesh is not None
            and torch.distributed.is_initialized() else "single")
    path = os.path.join(out_dir, f"serve_{rank}.pt")
    torch.save(arrays, path)
    seconds["save"] = time.perf_counter() - t0
    return dict(out, arrays=path)


def expected_cache_shard(model, cache: Dict, coords: Dict, mesh_shape
                         ) -> Dict:
    """The slices of a whole cache (numpy) that the rank at ``coords`` of a
    ``(data, model)`` mesh of ``mesh_shape`` holds, by ``cache_spec``."""
    from repro_torch.bench.sharded_train import at_coords
    from repro_torch.distributed.sharding import shard_leaf

    at = at_coords(coords, mesh_shape)
    specs = model.sharding_rules(at).cache_tree(cache)
    return {k: shard_leaf(torch.from_numpy(np.array(v)), specs[k],
                          at).numpy() for k, v in cache.items()}


def many(calls: Sequence[Tuple[Any, tuple]]) -> list:
    """Each ``(fn, args)`` of ``calls`` in turn on this rank, their results
    in order: several jobs in one spawn of the ranks (the memory of each
    freed before the next)."""
    out = []
    for fn, args in calls:
        out.append(fn(*args))
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
    return out
