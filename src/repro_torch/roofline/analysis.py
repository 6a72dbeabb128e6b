"""The roofline of one NVIDIA H100 (port of ``repro.roofline.analysis.HW``
and ``benchmarks/common.py``'s ``tpu_time_model``).

Peaks of the H100 SXM5 80GB, from NVIDIA's data sheet
(https://www.nvidia.com/en-us/data-center/h100/), dense rates without
sparsity, at the full 700 W power limit: 989 TFLOP/s bf16 on the tensor
cores, 67 TFLOP/s float32 outside them, 80 GB of HBM3 at 3.35 TB/s, NVLink
at 900 GB/s in all (450 GB/s each way), and a 50 MB L2 cache.  A card set
below 700 W runs slower under load: a share of these peaks is stated with
the card's power limit beside it.

The reference's HLO functions (``bf16_convert_penalty``,
``collective_bytes_from_hlo``, ``RooflineReport``, ``xla_costs``,
``analyze_compiled``) read XLA's compiled artefacts and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


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
