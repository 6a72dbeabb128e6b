"""Energy read from the card: NVML's cumulative energy counter
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the counter
started) through ``ctypes`` on ``libnvidia-ml.so.1``.  The NVML device is
the one at the PCI bus id torch reports for the card in use, so it is the
same card whatever ``CUDA_VISIBLE_DEVICES`` maps.  A card whose counter
cannot be read raises; nothing is estimated in its place.
"""
from __future__ import annotations

import ctypes
import time
from typing import Callable, Dict

import torch

_NVML = None
SECONDS = 2.0       # a loop's least length: the counter moves in steps


def _nvml():
    global _NVML
    if _NVML is None:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
        _check(lib.nvmlInit_v2(), "nvmlInit_v2")
        _NVML = lib
    return _NVML


def _check(ret: int, what: str) -> None:
    if ret != 0:
        raise RuntimeError(f"NVML {what} returned {ret}: the card's energy "
                           "counter cannot be read")


def pci_bus_id(device) -> str:
    """``domain:bus:device.0`` of ``device``, as NVML spells it."""
    p = torch.cuda.get_device_properties(torch.device(device))
    return f"{p.pci_domain_id:08X}:{p.pci_bus_id:02X}:{p.pci_device_id:02X}.0"


class EnergyCounter:
    """The NVML handle of one card: its cumulative energy (J) and its
    instantaneous power draw (W)."""

    def __init__(self, device):
        self.lib = _nvml()
        self.bus_id = pci_bus_id(device)
        self.handle = ctypes.c_void_p()
        _check(self.lib.nvmlDeviceGetHandleByPciBusId_v2(
            self.bus_id.encode(), ctypes.byref(self.handle)),
            f"nvmlDeviceGetHandleByPciBusId_v2({self.bus_id})")

    def joules(self) -> float:
        mj = ctypes.c_ulonglong()
        _check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3

    def watts(self) -> float:
        mw = ctypes.c_uint()
        _check(self.lib.nvmlDeviceGetPowerUsage(self.handle,
                                                ctypes.byref(mw)),
               "nvmlDeviceGetPowerUsage")
        return mw.value / 1e3


def measure(fn: Callable[[], object], counter: EnergyCounter,
            device) -> Dict[str, float]:
    """Call ``fn`` once, then back to back until at least ``SECONDS`` have
    passed (a synchronise every 10 calls), between two reads of the energy
    counter: ``{"calls", "seconds", "joules", "watts"}`` of the loop, its
    mean watts with the card's idle power in them."""
    fn()
    torch.cuda.synchronize(device)
    calls = 0
    j0, t0 = counter.joules(), time.perf_counter()
    while True:
        for _ in range(10):
            fn()
        calls += 10
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if dt >= SECONDS:
            break
    joules = counter.joules() - j0
    return {"calls": calls, "seconds": dt, "joules": joules,
            "watts": joules / dt}
