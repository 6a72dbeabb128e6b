"""The port's STREAM ops on the CPU against the JAX package: the plain
versions and the wrappers (a CPU tensor takes the plain version) against
``repro.kernels.stream.ref`` and the Pallas kernels in interpret mode, at
``tests/test_kernels.py``'s STREAM shapes.

float32: bitwise equal to the jnp reference, which rounds TRIAD's product
and its sum separately as the port's plain version and kernel do.  The
Pallas kernels in interpret mode equal it bitwise for ADD and SCALE; for
TRIAD, XLA on the CPU contracts ``s * a + b`` into one fused multiply-add,
so there the port is held within the rounding of the product and of the
sum (one float32 ulp of each) of the kernel, and the kernel is checked to
be exactly the once-rounded value.  bfloat16: atol
2e-2 against the Pallas kernels, as ``tests/test_kernels.py`` holds them,
and bitwise against the jnp reference where the scalar is exact in
bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream import ref as jax_ref
from repro.kernels.stream.kernel import add_pallas, scale_pallas, triad_pallas
from repro_torch.kernels.stream import ops, ref

# tests/test_kernels.py's (rows, block_rows, dtype)
CASES = [(512, 16, "float32"), (1024, 256, "float32"), (512, 8, "bfloat16")]


def _inputs(rows, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((2, rows * 128)).astype(np.float32)
    return ((jnp.asarray(a, getattr(jnp, dtype)),
             jnp.asarray(b, getattr(jnp, dtype))),
            (torch.from_numpy(a).to(getattr(torch, dtype)),
             torch.from_numpy(b).to(getattr(torch, dtype))))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _results(a, b, scalar, block_rows):
    """The port's plain results and wrapper results of the three ops."""
    plain = [ref.add_ref(a, b), ref.scale_ref(a, scalar),
             ref.triad_ref(a, b, scalar)]
    wrapped = [ops.stream_add(a, b, block_rows),
               ops.stream_scale(a, scalar, block_rows),
               ops.stream_triad(a, b, scalar, block_rows)]
    return plain, wrapped


@pytest.mark.parametrize("scalar", [3.0, 0.1])
@pytest.mark.parametrize("rows,block_rows,dtype", CASES)
def test_stream_matches_jax_ref_and_pallas(rows, block_rows, dtype, scalar):
    (aj, bj), (a, b) = _inputs(rows, dtype)
    plain, wrapped = _results(a, b, scalar, block_rows)
    for p, w in zip(plain, wrapped):
        assert torch.equal(p, w) and p.dtype == a.dtype
    s = jnp.asarray(scalar, aj.dtype)      # the ref's weak-typed scalar
    want = [jax_ref.add_ref(aj, bj), jax_ref.scale_ref(aj, s),
            jax_ref.triad_ref(aj, bj, s)]
    a2, b2 = aj.reshape(rows, 128), bj.reshape(rows, 128)
    pallas = [add_pallas(a2, b2, block_rows=block_rows),
              scale_pallas(a2, scalar, block_rows=block_rows),
              triad_pallas(a2, b2, scalar, block_rows=block_rows)]
    for op, p, w, k in zip(("add", "scale", "triad"), plain, want, pallas):
        k = _np(k).reshape(-1)
        if dtype == "float32":
            np.testing.assert_array_equal(_np(p), _np(w))
            if op != "triad":
                np.testing.assert_array_equal(_np(p), k)
                continue
            an, bn = _np(a).astype(np.float64), _np(b).astype(np.float64)
            s32 = np.float64(np.float32(scalar))
            np.testing.assert_array_equal(k, (s32 * an + bn).astype(
                np.float32))                  # one rounding: a fused FMA
            prod = np.abs(_np(ref.scale_ref(a, scalar)))
            assert np.all(np.abs(_np(p) - k)
                          <= np.spacing(prod) + np.spacing(np.abs(k)))
        else:
            np.testing.assert_allclose(_np(p), k, rtol=0, atol=2e-2)
            if scalar == 3.0:
                np.testing.assert_array_equal(_np(p), _np(w))


def test_scalar_is_rounded_to_the_dtype_first():
    a = torch.ones(128, dtype=torch.bfloat16)
    s = ref.cast_scalar(0.1, torch.bfloat16)
    assert s == torch.tensor(0.1, dtype=torch.bfloat16).item() != 0.1
    assert torch.equal(ops.stream_scale(a, 0.1, 1), torch.full_like(a, s))
    assert ref.cast_scalar(0.1, torch.float32) == np.float32(0.1)


def test_triad_rounds_the_product_before_the_add():
    # s * a + b with one rounding (an FMA) differs here from two roundings
    a = torch.tensor([1.0 + 2 ** -23] * 128)
    b = torch.tensor([-1.0] * 128)
    got = ops.stream_triad(a, b, 1.0 + 2 ** -23, 1)
    two = torch.tensor((1.0 + 2 ** -23) ** 2, dtype=torch.float32) - 1.0
    assert torch.equal(got, torch.full_like(a, two.item()))
    assert got[0].item() != (1.0 + 2 ** -23) ** 2 - 1.0


def test_stream_cpu_does_not_count_launches():
    (_, _), (a, b) = _inputs(16, "float32")
    before = [op.launches for op in ops.OPS]
    _results(a, b, 3.0, 4)
    assert [op.launches for op in ops.OPS] == before


@pytest.mark.parametrize("n,block_rows", [(200, 1), (128 * 6, 4),
                                          (128 * 4, 0)])
def test_stream_refuses_partial_rows_and_tiles(n, block_rows):
    a = torch.ones(n)
    for call in (lambda: ops.stream_add(a, a, block_rows),
                 lambda: ops.stream_scale(a, 2.0, block_rows),
                 lambda: ops.stream_triad(a, a, 2.0, block_rows)):
        with pytest.raises(ValueError):
            call()


def test_stream_refuses_mismatched_shapes():
    with pytest.raises(ValueError):
        ops.stream_add(torch.ones(256), torch.ones(128), 1)
    with pytest.raises(ValueError):
        ops.stream_scale(torch.ones(2, 128), 2.0, 1)
