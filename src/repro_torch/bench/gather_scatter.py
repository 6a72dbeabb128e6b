"""Paper Fig 9: GUPS-style random row gather and scatter, swept over the
row width, through the port's CUDA kernels (port of
``benchmarks/gather_scatter.py``).

For each row width (16 to 2048 bytes, float32) a table of R rows, N ids
drawn uniformly (so some repeat) and N source rows: the gather
(``vector_gather``) and the in-place scatter (``vector_scatter_``), then
one PyTorch call each on the same inputs, timed as a yardstick and used
nowhere in the port (:func:`yardsticks`).  Each row prints the wrapper's
time per call (``ms``, host work included), two byte counts and the H100
roofline's time for each:

* ``bytes`` (useful bytes, :func:`useful_bytes`): gather the distinct
  table rows read, N rows written and the ids; scatter the winning source
  row of each distinct target read, the distinct target rows written and
  the ids (a repeated id's row need be moved once);
* ``sector_bytes`` (:func:`sector_bytes`): the same accesses counted in
  the 32-byte sectors the memory system moves (a 16-byte row costs a
  whole one; ``sector_eff`` is a row's share of the sectors it touches).

On the card each kernel is first held bitwise against its plain version
(:func:`check_bits`), and the rows add the kernel's own time
(``kernel_ms``, back-to-back launches through the C entry point) and the
useful GB/s it reaches with its share of the 3.35 TB/s; the yardsticks
are timed over back-to-back calls on the card, per call on the CPU.  The
reference's TPU tile-waste formula does not carry over.

    python -m repro_torch.bench.gather_scatter [--device cpu] [--full]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.bench.common import (CALLS, device_ms, device_name, emit,
                                      kernel_ms, rates, roofline_ms, time_ms)
from repro_torch.kernels.gather_scatter import ops, ref

SIZES = {True: (65_536, 8_192), False: (4_000_000, 1_000_000)}   # (R, N)
VEC_BYTES = (16, 64, 128, 256, 512, 2048)
SECTOR = 32
# the scatter's yardstick when it computes the last-write rule
INDEX_PUT = "deterministic index_put_"
NO_LAST_WRITE = "none (no PyTorch call computes the last-write rule)"


def winners(idx: torch.Tensor, R: int) -> torch.Tensor:
    """The draws that win the scatter: the last draw of each distinct row
    (ids wrapped; ids outside ``[-R, R)`` dropped), in row order."""
    g, ok = ref.wrap_ids(idx, R)
    draw = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((R,), -1, dtype=torch.long, device=idx.device)
    last.scatter_reduce_(0, g[ok], draw[ok], reduce="amax")
    return last[last >= 0]


def sectors(rows: torch.Tensor, row_bytes: int) -> Tuple[int, int]:
    """(touched, partial): the 32-byte sectors that rows ``rows``
    (distinct) of a sector-aligned array of ``row_bytes``-byte rows touch,
    and how many of those the rows cover only in part."""
    if row_bytes % SECTOR == 0:
        return rows.numel() * (row_bytes // SECTOR), 0
    start = (rows * row_bytes)[:, None]
    span = torch.arange(-(-row_bytes // SECTOR) + 1, device=rows.device)
    sec = start // SECTOR + span
    cover = (torch.minimum((sec + 1) * SECTOR, start + row_bytes)
             - torch.maximum(sec * SECTOR, start)).clamp(min=0)
    hit = cover > 0
    uniq, inv = torch.unique(sec[hit], return_inverse=True)
    full = torch.zeros_like(uniq).scatter_add_(0, inv, cover[hit])
    return uniq.numel(), int((full < SECTOR).sum())


def useful_bytes(op: str, idx: torch.Tensor, R: int, row_bytes: int) -> int:
    """The bytes ``op`` (``"gather"`` or ``"scatter"``) must move: each
    distinct row once, the ids once."""
    N = idx.shape[0]
    if op == "gather":
        return (torch.unique(idx).numel() + N) * row_bytes + 4 * N
    return 2 * winners(idx, R).numel() * row_bytes + 4 * N


def sector_bytes(op: str, idx: torch.Tensor, R: int, row_bytes: int) -> int:
    """:func:`useful_bytes` counted in 32-byte sectors: the sectors of the
    distinct table rows and, for the scatter, of the winning source rows,
    plus a read of each table sector the scatter writes only in part (a
    random 16-byte write costs an H100 1.27x a 32-byte one: ``PERF.md``
    §6); the contiguous output and ids rounded up to whole sectors."""
    N = idx.shape[0]
    ids = -(-4 * N // SECTOR)
    if op == "gather":
        rows = torch.unique(ref.wrap_ids(idx, R)[0])
        out = -(-N * row_bytes // SECTOR)
        return SECTOR * (sectors(rows, row_bytes)[0] + out + ids)
    won = winners(idx, R)
    written, partial = sectors(ref.wrap_ids(idx[won], R)[0], row_bytes)
    return SECTOR * (sectors(won, row_bytes)[0] + written + partial + ids)


def check_bits(op, table, *rest) -> None:
    """Card only: raises unless the kernel behind ``op`` (launched through
    its C entry point, so the wrapper's count does not move) on a copy of
    ``table`` gives the plain version's bits, NaN rows included."""
    launch = op.prepare(table.clone(), *rest)
    if launch.fn(*launch.argv) != 0:
        raise RuntimeError(f"{op.name} kernel launch failed")
    want = op.plain(table.clone(), *rest)
    if not torch.equal(launch.out.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{op.name}: kernel != plain version")


def deterministic_index_put_(table, idx_long, src):
    """``table.index_put_((idx_long,), src)`` under
    ``torch.use_deterministic_algorithms(True)`` (and without filling new
    memory), the settings restored after."""
    import torch.utils.deterministic as det

    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    fill = det.fill_uninitialized_memory
    try:
        torch.use_deterministic_algorithms(True)
        det.fill_uninitialized_memory = False
        return table.index_put_((idx_long,), src, accumulate=False)
    finally:
        det.fill_uninitialized_memory = fill
        torch.use_deterministic_algorithms(was, warn_only=warn)


def yardsticks(table, idx, src) -> Dict[str, object]:
    """The PyTorch calls timed beside the kernels (ids must lie in
    ``[0, R)``): ``gather`` is ``index_select``; ``scatter`` is the
    deterministic ``index_put_`` where it gives the plain version's bits
    on these inputs, repeats included, else None; ``index_copy`` is
    ``index_copy_``, which has no last-write rule (its result on repeated
    ids is undefined), timed either way.  ``scatter_name`` says which."""
    idx_long = idx.long()
    want = ref.scatter_ref_(table.clone(), idx, src)
    got = deterministic_index_put_(table.clone(), idx_long, src)
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    del got, want
    return dict(
        gather=lambda: torch.index_select(table, 0, idx),
        scatter=((lambda: deterministic_index_put_(table, idx_long, src))
                 if same else None),
        scatter_name=INDEX_PUT if same else NO_LAST_WRITE,
        index_copy=lambda: table.index_copy_(0, idx_long, src))


def run(device="cuda", quick: bool = True, R: Optional[int] = None,
        N: Optional[int] = None, vec_bytes: Sequence[int] = VEC_BYTES
        ) -> List[Dict[str, object]]:
    """Gather and scatter at each row width; returns the rows printed.
    Rows carry ``op``, ``calls`` and ``launches`` (what the wrapper's
    count rose by), ``bytes``, ``sector_bytes``, ``library`` (the
    yardstick's name) and ``library_ms`` (None where no PyTorch call
    computes the function), the scatter also ``index_copy_ms``, and on
    the card ``kernel_ms``."""
    dev = device_lib.resolve(device)
    R = R or SIZES[quick][0]
    N = N or SIZES[quick][1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    where = f"device={device_name(dev)}"

    def timed(fn):
        if fn is None:
            return None
        return (device_ms(fn, device=dev) if dev.type == "cuda"
                else time_ms(fn, device=dev))

    rows: List[Dict[str, object]] = []
    for vb in vec_bytes:
        D = max(vb // 4, 1)
        table = torch.randn((R, D), generator=gen, device=dev)
        src = torch.randn((N, D), generator=gen, device=dev)
        idx = torch.randint(0, R, (N,), generator=gen, device=dev,
                            dtype=torch.int32)
        distinct = torch.unique(idx).numel()
        sector_eff = vb / (-(-vb // SECTOR) * SECTOR)
        yard = yardsticks(table, idx, src)
        for name, op, args in (
                ("gather", ops.vector_gather, (table, idx)),
                ("scatter", ops.vector_scatter_, (table, idx, src))):
            nbytes = useful_bytes(name, idx, R, vb)
            nsect = sector_bytes(name, idx, R, vb)
            if dev.type == "cuda":
                check_bits(op, *args)
            before = op.launches
            ms = time_ms(op, *args, device=dev)
            launches = op.launches - before
            k_ms = kernel_ms(op, *args, device=dev)
            library = ("index_select" if name == "gather"
                       else yard["scatter_name"])
            library_ms = timed(yard[name])
            copy_ms = timed(yard["index_copy"]) if name == "scatter" else None
            row = emit(f"{name}_{vb}B", ms,
                       f"R={R};N={N};distinct={distinct};bytes={nbytes};"
                       f"h100_roofline_ms="
                       f"{roofline_ms(0, nbytes, torch.float32):.6g};"
                       f"sector_bytes={nsect};h100_sector_ms="
                       f"{roofline_ms(0, nsect, torch.float32):.6g};"
                       f"sector_eff={sector_eff:.2f};library={library};"
                       f"library_ms="
                       + ("none" if library_ms is None else f"{library_ms:.6g}")
                       + (f";index_copy_ms={copy_ms:.6g} (no last-write "
                          "rule)" if copy_ms is not None else "")
                       + (f";kernel_ms={k_ms:.6g}" if k_ms is not None else "")
                       + f"{rates(k_ms, 0, nbytes)};{where}")
            row.update(op=op.name, vec_bytes=vb, R=R, N=N, bytes=nbytes,
                       sector_bytes=nsect, distinct=distinct,
                       kernel_ms=k_ms, library=library,
                       library_ms=library_ms, index_copy_ms=copy_ms,
                       calls=CALLS, launches=launches)
            rows.append(row)
        del table, src, yard
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    run(args.device, quick=not args.full)


if __name__ == "__main__":
    main()
