"""The roofline of one NVIDIA H100 (port of ``repro.roofline.analysis.HW``
and ``benchmarks/common.py``'s ``tpu_time_model``).

Peaks of the H100 SXM5 80GB, from NVIDIA's data sheet
(https://www.nvidia.com/en-us/data-center/h100/), dense rates without
sparsity, at the full 700 W power limit: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 80 GB of HBM3 at 3.35 TB/s, NVLink
at 900 GB/s in all (450 GB/s each way), and a 50 MB L2 cache.  A card set
below 700 W runs slower under load: a share of these peaks is stated with
the card's power limit beside it.

:class:`RooflineReport` keeps the reference's fields and terms on these
peaks: compute at the peak for the step's dtype, memory at the HBM rate,
collectives at the NVLink rate.  :func:`step_costs` takes the place of
``xla_costs`` / ``analyze_compiled``: it runs a step once in eager mode
and counts what it does (see its docstring), on the meta device as well as
on a real one.  Not ported: ``collective_bytes_from_hlo`` and
``bf16_convert_penalty``, which parse XLA's HLO text; an eager PyTorch
step has no counterpart of that text, and one card runs no collective.
"""
from __future__ import annotations

import gc
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


@dataclass(frozen=True)
class HW:
    """One H100 SXM5 80GB: peak rates per second and sizes in bytes."""
    name: str = "NVIDIA H100 SXM5 80GB"
    peak_bf16: float = 989e12        # FLOP/s, tensor cores, dense
    peak_f32: float = 67e12          # FLOP/s, outside the tensor cores
    hbm_bw: float = 3.35e12          # B/s
    hbm_bytes: float = 80e9
    nvlink_bw: float = 450e9         # B/s each way, to the host's other cards
    l2_bytes: float = 50e6

    def fits_in_l2(self, nbytes: float) -> bool:
        """Whether ``nbytes`` (all the arrays an op reads and writes) fit
        in the L2 cache, where a time measures the L2, not the HBM.  A
        share of the HBM rate means something only at four times the L2 or
        more (STREAM's rule); sizes in between measure neither."""
        return nbytes <= self.l2_bytes

    def peak(self, dtype: torch.dtype) -> float:
        """Peak operations per second on ``dtype`` inputs: the tensor-core
        rate for bf16 and fp16, the float32 rate for float32."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_bf16
        if dtype == torch.float32:
            return self.peak_f32
        raise ValueError(f"no peak rate for {dtype}")


H100 = HW()


def time_model(flops: float, nbytes: float, dtype: torch.dtype,
               hw: HW = H100) -> float:
    """The least seconds ``hw`` could take: the larger of ``flops`` over the
    peak rate for ``dtype`` and ``nbytes`` over the memory rate."""
    return max(flops / hw.peak(dtype), nbytes / hw.hbm_bw)


def bound_by(flops: float, nbytes: float, dtype: torch.dtype,
             hw: HW = H100) -> str:
    """Which of the two terms of :func:`time_model` is the larger:
    ``"operations"`` or ``"bytes"``."""
    return ("bytes" if nbytes / hw.hbm_bw >= flops / hw.peak(dtype)
            else "operations")


@dataclass
class RooflineReport:
    """The roofline of one step (the reference's record): its counted
    FLOPs and bytes (``hlo_*``, the reference's names), collective bytes,
    analytic model FLOPs and peak memory, on ``chips`` cards of ``hw``.
    ``dtype`` picks the compute peak."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0
    memory_per_device: float = 0.0
    hw: HW = field(default_factory=HW)
    dtype: torch.dtype = torch.bfloat16

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak(self.dtype))

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.hw.nvlink_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step seconds: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips x peak x roofline step time)."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.hw.peak(self.dtype) * t)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "memory_per_device": self.memory_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    """Counts the bytes each aten op reads and writes, and the live bytes
    of the storages the ops make (see :func:`step_costs`)."""

    def __init__(self, inputs):
        super().__init__()
        self.bytes = 0
        # storages live at the start: counted once, never released
        self.kept = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                     for t in inputs}
        self.live = sum(self.kept.values())
        self.peak = self.live
        self.made = set()

    def _release(self, key: int, nbytes: int) -> None:
        self.made.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        fresh = [t for t in outs
                 if t.untyped_storage()._cdata not in in_keys]
        # a view (every result on an input's storage) moves no data; an
        # in-place op reads its inputs and writes its result
        if fresh or func._schema.is_mutable:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in fresh:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self.kept or key in self.made:
                continue
            self.made.add(key)
            self.live += storage.nbytes()
            weakref.finalize(storage, self._release, key, storage.nbytes())
        self.peak = max(self.peak, self.live)
        return out


def step_costs(fn: Callable, *args) -> Dict[str, object]:
    """Run ``fn(*args)`` once and count its costs: ``{"flops", "bytes",
    "collectives", "peak_memory"}`` (plus ``max_memory_allocated`` on a
    card).

    * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` (the
      products: matmuls, convolutions, attention);
    * ``bytes``: the sum of every aten op's operand and result bytes, as a
      ``TorchDispatchMode`` sees them; ops whose results all lie on an
      input's storage (views) move nothing.  That is what an eager step
      moves, where no op is fused; it is not XLA's post-fusion count;
    * ``collectives``: ``{"total": 0.0}``, one card;
    * ``peak_memory``: the storages of ``args`` plus the peak of the live
      storages the ops make: a storage counts from the op that makes it
      until it is freed (a finalizer on it), once however many views it
      has, and a result on an input's storage (a view, an in-place op)
      adds nothing.  The garbage collector is off during the call, so a
      storage in a reference cycle lives to its end and the peak does not
      depend on when a collection runs.

    On the meta device nothing is computed or allocated, so a full-size
    step counts in seconds.  On a card the step really runs;
    ``max_memory_allocated`` is then the caching allocator's peak over the
    call.
    """
    inputs = _tensors(args)
    dev = inputs[0].device if inputs else torch.device("cpu")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counter = FlopCounterMode(display=False)
    mode = _CostMode(inputs)
    # the collector off: a storage held in a reference cycle is freed at
    # the end, not whenever a collection happens to run
    gc.collect()
    gc.disable()
    try:
        with counter, mode:
            out = fn(*args)
        del out
    finally:
        gc.enable()
    costs: Dict[str, object] = {
        "flops": float(counter.get_total_flops()),
        "bytes": float(mode.bytes),
        "collectives": {"total": 0.0},
        "peak_memory": float(mode.peak),
    }
    if on_card:
        torch.cuda.synchronize(dev)
        costs["max_memory_allocated"] = float(
            torch.cuda.max_memory_allocated(dev))
    return costs
