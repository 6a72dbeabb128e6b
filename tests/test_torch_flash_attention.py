"""The port's dense flash attention on the CPU against the JAX package: the
plain version and the wrapper (a CPU tensor takes the plain version)
against ``repro.kernels.flash_attention.ref`` and the Pallas kernel in
interpret mode, at ``tests/test_kernels.py``'s flash shapes.

Tolerances: float32 atol 1e-5 against the jnp reference (the same one-pass
softmax, summed in another order) and 2e-3 against the Pallas kernel (an
online softmax over 64-key tiles), as ``tests/test_kernels.py`` holds the
kernel; bfloat16 atol 2e-2 against both (the scores and weights are
rounded to bfloat16 at other places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention.ops import (check_shapes,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (bf16_share,
                                                     flash_attention_ref)

# tests/test_kernels.py's (B, S, H, KV, hd, causal, dtype), then
# smollm-360m's grouping (15 q heads over 5 kv heads) at a short sequence
CASES = [(2, 128, 4, 2, 64, True, "float32"),
         (1, 256, 6, 6, 64, False, "float32"),
         (2, 64, 8, 2, 128, True, "float32"),
         (1, 128, 4, 4, 64, True, "bfloat16"),
         (1, 64, 15, 5, 64, True, "float32")]


def _inputs(B, S, H, KV, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,dtype", CASES)
def test_flash_matches_jax_ref_and_pallas(B, S, H, KV, hd, causal, dtype):
    (qj, kj, vj), (q, k, v) = _inputs(B, S, H, KV, hd, dtype)
    plain = flash_attention_ref(q, k, v, causal=causal)
    assert plain.shape == q.shape and plain.dtype == q.dtype
    assert torch.equal(flash_attention(q, k, v, causal=causal, bq=64,
                                       bk=64), plain)
    want = jax_ref(qj, kj, vj, causal=causal)
    pallas = flash_attention_pallas(qj, kj, vj, causal=causal, bq=64, bk=64,
                                    interpret=True)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(_np(plain), _np(want), rtol=0,
                               atol=2e-2 if bf16 else 1e-5)
    np.testing.assert_allclose(_np(plain), _np(pallas), rtol=0,
                               atol=2e-2 if bf16 else 2e-3)


def test_flash_sm_scale_and_causal_rows():
    (qj, kj, vj), (q, k, v) = _inputs(1, 32, 4, 2, 16, "float32", seed=1)
    got = flash_attention_ref(q, k, v, causal=True, sm_scale=0.3)
    np.testing.assert_allclose(
        _np(got), _np(jax_ref(qj, kj, vj, causal=True, sm_scale=0.3)),
        rtol=0, atol=1e-5)
    # causal row 0 sees only key 0: its output is v[0] of its kv head
    np.testing.assert_allclose(_np(got[:, 0]),
                               _np(v[:, 0].repeat_interleave(2, dim=1)),
                               rtol=0, atol=1e-6)


def test_flash_cpu_does_not_count_launches():
    _, (q, k, v) = _inputs(*CASES[0][:5], "float32")
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before


def test_flash_refuses_what_the_tpu_grid_refuses():
    _, (q, k, v) = _inputs(1, 96, 4, 2, 16, "float32")
    flash_attention(q, k, v, bq=32, bk=96)        # 96 % 32 == 0
    with pytest.raises(ValueError):               # 96 % 64 != 0
        flash_attention(q, k, v, bq=64)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, bq=32, bk=64)
    with pytest.raises(ValueError):               # k of another length
        flash_attention(q, k[:, :64], v[:, :64], bq=32, bk=32)
    with pytest.raises(ValueError):               # 4 q heads over 3
        check_shapes(q, k[:, :, :1].repeat(1, 1, 3, 1),
                     v[:, :, :1].repeat(1, 1, 3, 1), 32, 32)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)


@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 128, 6, 2, 64),    # G = 3
                                         (2, 64, 8, 2, 32)])    # G = 4
def test_bf16_limit_holds_for_the_reference_kernel(B, S, H, KV, hd):
    """The card's bf16 limit (``bf16_share`` at most 1, as chip_smoke.py
    phase 21 and the card tests hold the kernel) is met by the Pallas
    kernel in bf16 over 32-key tiles: unnormalised weights rounded for the
    PV product, l summed unrounded, _flash_kernel's own rounding.  Outputs
    under 0.25 moved by 8 ulps do not meet it."""
    (qj, kj, vj), (q, k, v) = _inputs(B, S, H, KV, hd, "bfloat16", seed=3)
    pallas = torch.from_numpy(_np(flash_attention_pallas(
        qj, kj, vj, causal=True, bq=32, bk=32, interpret=True))).bfloat16()
    assert bf16_share(pallas, q, k, v, True) <= 1
    small = (pallas.float().abs() < 0.25).to(torch.int16)
    control = (pallas.view(torch.int16) + 8 * small).view(torch.bfloat16)
    assert bf16_share(control, q, k, v, True) > 1


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelI13__nv_bfloat16Li128EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelI13__nv_bfloat16Li128EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 648 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelIfLi16EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelIfLi16EEEvPKT_
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 776 bytes smem, 440 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_smem_and_spills():
    from repro_torch.kernels.build import ptxas_report

    bf16, f32 = ptxas_report(PTXAS_LOG)
    assert "flash_kernelI13__nv_bfloat16Li128E" in bf16["entry"]
    assert (bf16["registers"], bf16["smem"], bf16["spill_stores"],
            bf16["spill_loads"], bf16["stack"]) == (128, 648, 0, 0, 0)
    assert (f32["registers"], f32["smem"], f32["spill_stores"],
            f32["spill_loads"], f32["stack"]) == (64, 776, 4, 12, 8)
    assert ptxas_report("") == []


def test_chip_smoke_reads_each_flash_instance_and_fails_on_a_spill():
    """``chip_smoke.py``'s phase 24 names each instance's tile from the
    ``-Xptxas -v`` log, adds its dynamic shared memory, and fails on a
    spill (the f32 hd-16 entry of the sample log spills)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    class Lib:
        @staticmethod
        def flash_attention_smem_bytes(hd, dtype):
            return 1000 * hd + dtype

    class Kernel:
        @staticmethod
        def library():
            return Lib

    bf16_log = PTXAS_LOG[:PTXAS_LOG.index(
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112flash_kernelIfLi16")]
    (row,) = smoke.flash_ptxas(Kernel, bf16_log, build, "card")
    assert row == dict(dtype="bfloat16", hd=128, tile="wgmma", registers=128,
                       smem_static=648, smem_dynamic=128001)
    with pytest.raises(AssertionError, match="float32, 16> spills"):
        smoke.flash_ptxas(Kernel, PTXAS_LOG, build, "card")
    with pytest.raises(AssertionError, match="no flash_kernel"):
        smoke.flash_ptxas(Kernel, "", build, "card")
