"""The port's row gather and scatter on the CPU against the JAX package:
the plain versions and the wrappers (a CPU table takes the plain version)
against ``repro.kernels.gather_scatter.ref`` and the Pallas kernels in
interpret mode at ``tests/test_kernels.py``'s shapes, bitwise at float32.

Ids outside ``[0, R)`` are checked against the jnp reference only (the
Pallas kernels take ids in range).  The scatter cases repeat ids: the last
write wins, in the jnp reference, in the Pallas kernel's sequential grid
and in the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_scatter import ref as jax_ref
from repro.kernels.gather_scatter.kernel import gather_pallas, scatter_pallas
from repro_torch.kernels.gather_scatter import ops, ref

# tests/test_kernels.py's (R, D, N), then narrow rows with N > R
CASES = [(100, 128, 37), (64, 256, 64), (50, 4, 200), (30, 3, 90)]


def _inputs(R, D, N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, D)).astype(dtype)
    idx = rng.integers(0, R, (N,)).astype(np.int32)
    src = rng.standard_normal((N, D)).astype(dtype)
    return table, idx, src


def _eq(got, want):
    """Bitwise equality, NaN included."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("R,D,N", CASES)
def test_gather_matches_jax_ref_and_pallas(R, D, N):
    table, idx, _ = _inputs(R, D, N)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    plain = ref.gather_ref(t, i)
    assert plain.shape == (N, D) and plain.dtype == torch.float32
    _eq(ops.vector_gather(t, i), plain.numpy())
    _eq(plain, jax_ref.gather_ref(jnp.asarray(table), jnp.asarray(idx)))
    _eq(plain, gather_pallas(jnp.asarray(table), jnp.asarray(idx),
                             interpret=True))


@pytest.mark.parametrize("R,D,N", CASES)
def test_scatter_matches_jax_ref_and_pallas(R, D, N):
    table, idx, src = _inputs(R, D, N, seed=1)
    idx[-1] = idx[0]                       # at least one repeated id
    t, i, s = map(torch.from_numpy, (table, idx, src))
    want = jax_ref.scatter_ref(jnp.asarray(table), jnp.asarray(idx),
                               jnp.asarray(src))
    plain = ref.scatter_ref(t, i, s)
    _eq(plain, want)
    _eq(plain, scatter_pallas(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(src), interpret=True))
    _eq(t, table)                          # scatter_ref copies
    _eq(ops.vector_scatter(t, i, s), plain.numpy())
    _eq(t, table)                          # vector_scatter copies too
    inplace = t.clone()
    assert ops.vector_scatter_(inplace, i, s) is inplace
    _eq(inplace, plain.numpy())
    _eq(plain[int(idx[0])], src[-1])       # the last write won


def test_edge_ids_match_jax_ref():
    """Wrapped negatives, ids past either end (a NaN row in the gather, a
    dropped write in the scatter) and repeats of them."""
    R, D = 20, 8
    table, _, _ = _inputs(R, D, 1, seed=2)
    idx = np.array([-1, -R, R, -R - 1, 2 ** 31 - 1, -2 ** 31, 5, -15, 5,
                    R - 1, -1], np.int32)
    src = np.arange(len(idx) * D, dtype=np.float32).reshape(-1, D)
    t, i, s = map(torch.from_numpy, (table, idx, src))
    tj, ij, sj = map(jnp.asarray, (table, idx, src))
    got = ops.vector_gather(t, i)
    _eq(got, jax_ref.gather_ref(tj, ij))
    assert torch.isnan(got).all(dim=1).tolist() == [
        False, False, True, True, True, True, False, False, False, False,
        False]
    _eq(ops.vector_scatter(t, i, s), jax_ref.scatter_ref(tj, ij, sj))


def test_bfloat16_rows_move_unchanged():
    R, D, N = 40, 5, 60
    table, idx, src = _inputs(R, D, N, seed=3)
    idx[:3] = [-1, R, -R - 1]
    t = torch.from_numpy(table).bfloat16()
    s = torch.from_numpy(src).bfloat16()
    i = torch.from_numpy(idx)
    got = ops.vector_gather(t, i)
    assert got.dtype == torch.bfloat16
    assert torch.isnan(got[1:3]).all() and not torch.isnan(got[3:]).any()
    assert torch.equal(got[3:], t[idx[3:]])
    want = t.clone()
    for n in range(N):                     # sequential: the last write wins
        if -R <= idx[n] < R:
            want[idx[n]] = s[n]
    assert torch.equal(ops.vector_scatter(t, i, s), want)


def test_gather_scatter_cpu_do_not_count_launches():
    table, idx, src = _inputs(*CASES[0])
    t, i, s = map(torch.from_numpy, (table, idx, src))
    before = [op.launches for op in ops.OPS]
    ops.vector_gather(t, i)
    ops.vector_scatter(t, i, s)
    assert [op.launches for op in ops.OPS] == before


def test_gather_scatter_refuse_bad_shapes():
    t, i, s = map(torch.from_numpy, _inputs(10, 4, 6))
    with pytest.raises(ValueError):
        ops.vector_gather(t[0], i)
    with pytest.raises(ValueError):
        ops.vector_gather(t, i[:, None])
    with pytest.raises(ValueError):
        ops.vector_scatter_(t, i, s[:, :3])
    with pytest.raises(ValueError):
        ops.vector_scatter(t, i, s[:5])
