"""Dry run: count every (architecture x input shape) step on the meta
device and write its roofline record (port of ``repro.launch.dryrun``),
on one H100 or for one rank of the reference's production meshes.

    python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    python -m repro_torch.launch.dryrun --all            # every cell
    python -m repro_torch.launch.dryrun --all --probes   # + depth probes
    python -m repro_torch.launch.dryrun --all --mesh 16x16
    python -m repro_torch.launch.dryrun --all --multi-pod   # 2x16x16

A cell's model is built on the meta device (``init_abstract``) and its
inputs are ``models.api.input_specs``; the step runs once under
``roofline.analysis.step_costs``, which counts its FLOPs, bytes and peak
memory without computing or allocating anything: ``train`` is
``loss_and_grads`` and an AdamW update (remat ``dots``, ``full`` for MoE,
as the reference), ``prefill`` the forward with the last position
unembedded, ``decode`` one ``decode_step`` on ``init_decode_cache(B, S)``.
Nothing is compiled, so the reference's trip-count correction is not
needed: an eager count visits every layer.  ``--probes`` still counts the
depth-1 and depth-2 models and checks that
``flops(d2) + (units - 2) * (flops(d2) - flops(d1))`` equals the full
count (relative 1e-9); a cell that misses fails.

Several cells are counted at once, one process a CPU core this process may
use, and in this process where there is one cell or one core.

The record is the reference's (``status``, ``full``, ``roofline``,
``probe_d1`` / ``probe_d2``).  The default mesh is ``"1"``: one card,
``chips`` 1, no collective.  ``--mesh 16x16``, and ``--multi-pod`` alone
(``2x16x16``; it takes no ``--mesh``), count the step of rank 0 of the
reference's production mesh (``launch.mesh.make_production_mesh``,
abstract: every collective is counted on meta tensors, not sent): the reference's ``jit_train_step``
(``shard_moe`` and ``moe_groups`` the data shards for MoE, as its
``_lower_compile`` sets them), ``jit_prefill_step`` and ``jit_serve_step``
on this rank's shards of params, batch and cache.  That count is one
device's, as the reference's ``cost_analysis`` is, and the record
globalises it as the reference does: ``hlo_flops``, ``hlo_bytes`` and
``collective_bytes`` are the rank's times ``chips`` (256 or 512).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import SHAPES, ModelConfig, ShapeCell, get_config
from repro_torch.configs import ASSIGNED_LM_ARCHS
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.models import stacking
from repro_torch.models.api import build_model, input_specs
from repro_torch.optim.optimizer import adamw
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.roofline.analysis import HW, RooflineReport, step_costs
from repro_torch.roofline.model_flops import model_flops
from repro_torch.serving import steps
from repro_torch.training.train_step import (
    TrainState, abstract_state, jit_train_step, make_train_step)

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH = "1"
SINGLE_POD = ("1", "16x16")    # one card; the one-pod production mesh
MESHES = SINGLE_POD + ("2x16x16",)
PROBE_RTOL = 1e-9

SKIP = {
    # long_500k needs sub-quadratic attention
    ("qwen3-moe-235b-a22b", "long_500k"): "full attention O(S^2) — skipped",
    ("granite-moe-1b-a400m", "long_500k"): "full attention O(S^2) — skipped",
    ("qwen2-1.5b", "long_500k"): "full attention O(S^2) — skipped",
    ("qwen3-32b", "long_500k"): "full attention O(S^2) — skipped",
    ("internlm2-20b", "long_500k"): "full attention O(S^2) — skipped",
    ("smollm-360m", "long_500k"): "full attention O(S^2) — skipped",
    ("internvl2-26b", "long_500k"): "full attention O(S^2) — skipped",
    ("whisper-tiny", "long_500k"): "full attention O(S^2) — skipped",
}


def production_mesh(mesh_name: str):
    """The abstract production mesh of ``mesh_name`` (None for one
    card)."""
    if mesh_name not in MESHES:
        raise ValueError(f"mesh {mesh_name!r}: expected one of {MESHES}")
    if mesh_name == MESH:
        return None
    return make_production_mesh(multi_pod=mesh_name == "2x16x16")


def cell_model(cfg: ModelConfig, cell: ShapeCell, device="meta", mesh=None):
    """The cell's model: remat ``dots`` for a dense train step, ``full``
    for MoE (the reference's choice), query chunks of 512; on a mesh a
    MoE model's experts split over ``model`` (``shard_moe``) and dispatched
    in one group a data shard (``moe_groups``), as the reference sets
    them."""
    remat = "full" if cfg.moe is not None else "dots"
    kw = {}
    if mesh is not None and cfg.moe is not None:
        groups = 1
        for a in data_axes(mesh):
            groups *= mesh.size(a)
        kw = {"shard_moe": True, "moe_groups": groups}
    return build_model(cfg, device=device, remat=remat, q_chunk=512, **kw)


def cell_step(model, cell: ShapeCell, params,
              inputs: Dict[str, torch.Tensor]) -> Tuple[Callable, tuple]:
    """``(fn, args)``: the cell's step and its arguments, on the model's
    device (meta for the count); prefill and decode run without autograd."""
    if cell.kind == "train":
        opt = adamw()
        step = make_train_step(model, opt, cosine_warmup(3e-4, 100, 1000))
        state = TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=model.device))
        return step, (state, inputs)
    if cell.kind == "prefill":
        return torch.no_grad()(steps.make_prefill_step(model)), (params,
                                                                 inputs)
    cache = model.init_decode_cache(cell.global_batch, cell.seq_len)
    return (torch.no_grad()(steps.make_serve_step(model)),
            (params, cache, inputs["tokens"]))


def mesh_step(model, cell: ShapeCell, mesh,
              inputs: Dict[str, torch.Tensor]) -> Tuple[Callable, tuple]:
    """``(fn, args)``: the cell's sharded step of this rank of ``mesh``
    (the reference's ``jit_*_step``s) on its shards of the params and the
    cache, as meta tensors, and the global inputs."""
    rules = model.sharding_rules(mesh)
    whole = model.init_abstract()
    params = model.shard_params(whole, mesh)
    if cell.kind == "train":
        opt = adamw()
        step = jit_train_step(model, opt, cosine_warmup(3e-4, 100, 1000),
                              mesh, rules, abstract_state(model, opt),
                              inputs)
        state = TrainState(params, opt.init(params), torch.zeros(
            (), dtype=torch.int32, device=model.device))
        return step, (state, inputs)
    if cell.kind == "prefill":
        return (steps.jit_prefill_step(model, mesh, rules, whole, inputs),
                (params, inputs))
    B, S = cell.global_batch, cell.seq_len
    step = steps.jit_serve_step(model, mesh, rules, whole,
                                steps.abstract_cache(model, B, S),
                                inputs["tokens"])
    return step, (params, model.init_decode_cache(B, S, mesh=mesh),
                  inputs["tokens"])


def count_cell(cfg: ModelConfig, cell: ShapeCell,
               mesh_name: str = MESH) -> Dict[str, object]:
    """``step_costs`` of the cell's step on the meta device: one card's,
    or rank 0's of a production mesh."""
    mesh = production_mesh(mesh_name)
    model = cell_model(cfg, cell, mesh=mesh)
    inputs = input_specs(cfg, cell)
    if mesh is None:
        fn, args = cell_step(model, cell, model.init_abstract(), inputs)
    else:
        fn, args = mesh_step(model, cell, mesh, inputs)
    return step_costs(fn, *args)


def run_cell(arch: str, shape: str, *, probes: bool = False,
             multi_pod: bool = False, mesh: Optional[str] = None,
             verbose: bool = True) -> dict:
    """One cell's record on :func:`resolve_mesh`'s mesh of ``mesh`` and
    ``multi_pod``."""
    rec = record(arch, shape, get_config(arch), SHAPES[shape], probes,
                 resolve_mesh(mesh, multi_pod))
    if verbose and rec["status"] == "ok":
        print_record(rec)
    return rec


def resolve_mesh(mesh: Optional[str] = None, multi_pod: bool = False) -> str:
    """The mesh a cell is counted on: ``mesh``, ``"1"`` (one card, the
    default) or ``"16x16"``; ``multi_pod`` alone is ``"2x16x16"``, and
    refuses a ``mesh`` beside it."""
    if multi_pod:
        if mesh is not None:
            raise ValueError(f"multi_pod is the 2x16x16 mesh; mesh {mesh!r} "
                             "contradicts it")
        return "2x16x16"
    mesh = MESH if mesh is None else mesh
    if mesh not in SINGLE_POD:
        raise ValueError(f"mesh {mesh!r}: expected one of {SINGLE_POD} "
                         "(2x16x16 is multi_pod)")
    return mesh


def record(arch: str, shape: str, cfg: ModelConfig, cell: ShapeCell,
           probes: bool, mesh_name: str = MESH) -> dict:
    """The cell's record: ``skipped``, or its counts and roofline; raises
    where the probes miss the full count."""
    mesh = production_mesh(mesh_name)
    chips = 1 if mesh is None else mesh.devices
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok",
           "ts": time.time()}
    if (arch, shape) in SKIP:
        return dict(rec, status="skipped", reason=SKIP[(arch, shape)])
    t0 = time.perf_counter()
    costs = count_cell(cfg, cell, mesh_name)
    rec["count_s"] = time.perf_counter() - t0
    rec["full"] = costs
    if probes:
        x1 = count_cell(cfg.with_depth(1), cell, mesh_name)
        x2 = count_cell(cfg.with_depth(2), cell, mesh_name)
        units = cfg.depth_units
        rec["probe_d1"] = {"flops": x1["flops"], "bytes": x1["bytes"]}
        rec["probe_d2"] = {"flops": x2["flops"], "bytes": x2["bytes"]}
        for key in ("flops", "bytes"):
            extra = x2[key] + (units - 2) * (x2[key] - x1[key])
            rel = abs(extra - costs[key]) / max(costs[key], 1.0)
            rec[f"probe_{key}_rel_err"] = rel
        if rec["probe_flops_rel_err"] > PROBE_RTOL:
            raise AssertionError(
                f"{arch} x {shape}: the depth probes extrapolate to "
                f"{rec['probe_flops_rel_err']:.3g} of the full count")
    report = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=costs["flops"] * chips, hlo_bytes=costs["bytes"] * chips,
        collective_bytes=costs["collectives"]["total"] * chips,
        collectives=costs["collectives"],
        model_flops=model_flops(cfg, cell),
        memory_per_device=costs["peak_memory"], hw=HW(),
        dtype=stacking.DTYPES[cfg.dtype])
    rec["dtype"] = cfg.dtype
    rec["roofline"] = report.to_dict()
    return rec


def print_record(rec: dict) -> None:
    r = rec["roofline"]
    print(f"--- {rec['arch']} x {rec['shape']} x {rec['mesh']} (count "
          f"{rec['count_s']:.1f}s): flops {r['hlo_flops']:.4g}, bytes "
          f"{r['hlo_bytes']:.4g}, peak "
          f"{r['memory_per_device'] / 2 ** 30:.2f} GiB | compute "
          f"{r['t_compute'] * 1e3:.3f} ms | memory "
          f"{r['t_memory'] * 1e3:.3f} ms | collective "
          f"{r['t_collective'] * 1e3:.3f} ms | bottleneck={r['bottleneck']} | "
          f"useful={r['useful_flops_ratio']:.2f} | MFU={r['mfu']:.3f}",
          flush=True)


def _cell(arch: str, shape: str, cfg: ModelConfig, cell: ShapeCell,
          probes: bool, mesh_name: str = MESH) -> dict:
    """:func:`record`, with an error written into the record."""
    try:
        return record(arch, shape, cfg, cell, probes, mesh_name)
    except Exception as e:
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None,
                   help="one arch (with --all: every shape of it)")
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--mesh", default=None, choices=SINGLE_POD,
                   help="one card (the default) or rank 0 of the 16x16 "
                        "production mesh")
    p.add_argument("--multi-pod", action="store_true",
                   help="rank 0 of the 2x16x16 production mesh (takes no "
                        "--mesh)")
    p.add_argument("--all", action="store_true")
    p.add_argument("--probes", action="store_true")
    p.add_argument("--out", default=str(OUT_DIR))
    args = p.parse_args(argv)
    if args.multi_pod and args.mesh is not None:
        p.error("--multi-pod is the 2x16x16 mesh; give no --mesh with it")
    name = resolve_mesh(args.mesh, args.multi_pod)
    if args.all:
        archs = [args.arch] if args.arch else ASSIGNED_LM_ARCHS
        cells = [(a, s) for a in archs for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        raise SystemExit("give --arch and --shape, or --all")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    # the configs and shapes are read here and handed to the workers
    work = [(a, s, get_config(a), SHAPES[s], args.probes, name)
            for a, s in cells]
    jobs = min(len(work), len(os.sched_getaffinity(0)))
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
            recs = list(pool.map(_cell, *zip(*work)))
    else:
        recs = [_cell(*w) for w in work]
    failures = 0
    for rec in recs:
        if rec["status"] == "ok":
            print_record(rec)
        failures += rec["status"] == "error"
        out = out_dir / f"{rec['arch']}__{rec['shape']}__{name}.json"
        out.write_text(json.dumps(rec, indent=2, default=float))
    print(f"\n{len(cells) - failures}/{len(cells)} cells OK")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
