"""The port's embedding bags on the CPU against the JAX package: the fused
BatchedTable plain version and the kernel wrapper (``device="cpu"`` takes
the plain version) against ``repro.core.embedding_api`` and the Pallas
kernel in interpret mode; the SingleTable baseline; the NaN and wrap
semantics of ids outside ``[0, R)``.

Tolerances: float32 atol 1e-5 against the jnp reference (sums in another
order) and 1e-6 against the Pallas kernel (both sum in float32); bfloat16
atol 3e-2 against both (the jnp reference sums in bfloat16, the port in
float32, as ``tests/test_kernels.py`` holds the Pallas kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding_api as jax_api
from repro.kernels.batched_embedding.kernel import batched_embedding_pallas
from repro_torch.core import embedding_api as api

# (R rows per table, D, B, T, L): tests/test_kernels.py's sweep, then
# RM2's geometry (T = 20 tables, L = 20, D = 64) at 64 rows.
CASES = [(64, 128, 3, 4, 5, "float32"), (32, 256, 2, 10, 20, "float32"),
         (64, 128, 2, 4, 1, "bfloat16"), (64, 64, 2, 20, 20, "float32")]


def _inputs(R, D, B, T, L, dtype, seed=0):
    rng = np.random.default_rng(seed)
    tbl = rng.standard_normal((R * T, D)).astype(np.float32)
    offs = (np.arange(T) * R).astype(np.int32)
    idx = rng.integers(0, R, (B, T, L)).astype(np.int32)
    tbl_j = jnp.asarray(tbl, dtype=getattr(jnp, dtype))
    tbl_t = torch.from_numpy(tbl).to(getattr(torch, dtype))
    return tbl_j, tbl_t, offs, idx


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("R,D,B,T,L,dtype", CASES)
def test_batched_lookup_matches_jax_and_pallas(R, D, B, T, L, dtype):
    tbl_j, tbl_t, offs, idx = _inputs(R, D, B, T, L, dtype)
    want = jax_api.batched_table_lookup(tbl_j, jnp.asarray(offs),
                                        jnp.asarray(idx))
    gid = jnp.asarray((idx + offs[None, :, None]).reshape(-1))
    pallas = batched_embedding_pallas(tbl_j, gid, L, interpret=True)
    plain = api.batched_table_lookup(tbl_t, torch.from_numpy(offs),
                                     torch.from_numpy(idx))
    op = api.embedding_bag(tbl_t, torch.from_numpy(offs),
                           torch.from_numpy(idx))
    assert plain.dtype == op.dtype == tbl_t.dtype
    assert plain.shape == op.shape == (B, T, D)
    assert torch.equal(op, plain)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(_np(plain), _np(want), rtol=0,
                               atol=3e-2 if bf16 else 1e-5)
    np.testing.assert_allclose(_np(plain).reshape(B * T, D), _np(pallas),
                               rtol=0, atol=3e-2 if bf16 else 1e-6)


def test_embedding_bag_cpu_does_not_count_launches():
    tbl_j, tbl_t, offs, idx = _inputs(*CASES[0])
    before = api.embedding_bag.launches
    api.embedding_bag(tbl_t, torch.from_numpy(offs), torch.from_numpy(idx))
    assert api.embedding_bag.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_table_lookup_matches_jax(dtype):
    R, D, B, T, L = 64, 64, 3, 5, 7
    tbl_j, tbl_t, offs, idx = _inputs(R, D, B, T, L, dtype, seed=1)
    tabs_j = [tbl_j[t * R:(t + 1) * R] for t in range(T)]
    tabs_t = [tbl_t[t * R:(t + 1) * R] for t in range(T)]
    want = jax_api.single_table_lookup(tabs_j, jnp.asarray(idx))
    got = api.single_table_lookup(tabs_t, torch.from_numpy(idx))
    assert got.dtype == tbl_t.dtype and got.shape == (B, T, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=3e-2 if dtype == "bfloat16" else 1e-5)
    big, offs_t = api.concat_tables(tabs_t)
    big_j, offs_j = jax_api.concat_tables(tabs_j)
    assert torch.equal(big, tbl_t)
    np.testing.assert_array_equal(offs_t.numpy(), np.asarray(offs_j))
    assert offs_t.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_of_range_ids_nan_and_wrap(dtype):
    """Global ids: >= R gives a NaN bag, [-R, 0) wraps to id + R, < -R is
    NaN; bags without such ids are untouched."""
    R, D, B, T, L = 8, 16, 4, 2, 3
    tbl_j, tbl_t, offs, idx = _inputs(R, D, B, T, L, dtype, seed=2)
    Rt = R * T
    idx[0, 0, 1] = Rt                  # global Rt: past the end
    idx[1, 1, 0] = -R - 1              # global -1: wraps to the last row
    idx[1, 0, 2] = -Rt                 # global -Rt: wraps to row 0
    idx[2, 0, 0] = -Rt - 1             # global -Rt - 1: NaN
    idx[3, 1, 2] = 10 ** 6             # far past the end
    want = _np(jax_api.batched_table_lookup(tbl_j, jnp.asarray(offs),
                                            jnp.asarray(idx)))
    got = _np(api.embedding_bag(tbl_t, torch.from_numpy(offs),
                                torch.from_numpy(idx)))
    nan_bags = {(0, 0), (2, 0), (3, 1)}
    for b in range(B):
        for t in range(T):
            assert np.isnan(got[b, t]).all() == ((b, t) in nan_bags)
            assert np.isnan(want[b, t]).all() == ((b, t) in nan_bags)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                               atol=3e-2 if dtype == "bfloat16" else 1e-5)
    last = tbl_t[Rt - 1].float().numpy()
    assert np.abs(got[1, 1] - (last + tbl_t[R + idx[1, 1, 1]].float().numpy()
                               + tbl_t[R + idx[1, 1, 2]].float().numpy())
                  ).max() < (3e-2 if dtype == "bfloat16" else 1e-5)
