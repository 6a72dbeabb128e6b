"""The port's ``bench.llm_e2e`` and ``bench.saturation`` against the
reference's ``benchmarks/llm_e2e.py`` and ``benchmarks/saturation.py`` on
the CPU, at ``REPRO_BENCH_SMOKE=1`` on the reference's model and weights,
under the proposer ``off`` and under ``ngram``: every derived field that is
not a time nor ``backend`` is equal.  The B2 sweep's derived fields equal
the reference's, and B2's plain version is within 1e-5 of the reference's
Pallas kernel in interpret mode at every (page, depth), with the same bits
across depths."""
import numpy as np
import pytest
import torch

from repro_torch.bench import llm_e2e, saturation
from repro_torch.core import attention_api
from repro_torch.serving import spec as tspec


def _run_reference(module, proposer):
    from benchmarks import common as jcommon
    from repro.serving import spec as jspec

    start = len(jcommon.RECORDS)
    with jspec.force_proposer(proposer):
        module.run(quick=True)
    rows = jcommon.RECORDS[start:]
    del jcommon.RECORDS[start:]
    return rows


def _fields(row, timed):
    kv = dict(f.split("=", 1) for f in row["derived"].split(";"))
    return {k: v for k, v in kv.items() if k not in timed + ("backend",)}


@pytest.mark.parametrize("proposer", ["off", "ngram"])
def test_llm_e2e_smoke_rows_equal_the_reference(monkeypatch, proposer):
    import jax  # noqa: F401  (the reference's benchmark runs on it)
    from benchmarks import llm_e2e as jllm

    monkeypatch.setenv("REPRO_BENCH_SMOKE", "1")
    want = _run_reference(jllm, proposer)
    with tspec.force_proposer(proposer):
        got = llm_e2e.run("cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert _fields(g, llm_e2e.TIMED) == _fields(w, llm_e2e.TIMED), \
            g["name"]
        assert llm_e2e.counters(g) == _fields(g, llm_e2e.TIMED)
    spec = {llm_e2e.counters(r).get("spec") for r in got} - {None}
    assert spec == {proposer}


def test_llm_e2e_smoke_skips_draft_model_and_refuses_a_mesh(monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_SMOKE", "1")
    with tspec.force_proposer("draft-model"):
        assert llm_e2e.run("cpu") == []
    monkeypatch.setenv("REPRO_BENCH_DEVICES", "2")
    with pytest.raises(ValueError, match="multi-card"):
        llm_e2e.run("cpu")
    with pytest.raises(ValueError, match="multi-card"):
        saturation.run("cpu")


@pytest.mark.parametrize("proposer", ["off", "ngram"])
def test_saturation_smoke_rows_equal_the_reference(monkeypatch, proposer):
    import jax  # noqa: F401
    from benchmarks import saturation as jsat

    monkeypatch.setenv("REPRO_BENCH_SMOKE", "1")
    want = _run_reference(jsat, proposer)
    with tspec.force_proposer(proposer):
        got = saturation.run("cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    timed = ("tok_s", "device_frac")
    for g, w in zip(got, want):
        fg, fw = _fields(g, timed), _fields(w, timed)
        if g["name"].startswith("paged_dma_profile"):
            # the port's rows say that the depth is not a DMA ring here
            assert fg.pop("prefetch") == "ignored"
            assert g["max_abs_err"] <= saturation.DMA_ATOL
        assert fg == fw, g["name"]


def test_dma_profile_plain_equals_the_pallas_kernel():
    import jax.numpy as jnp
    from repro.core.paged_kv import BlockAllocator as JAllocator
    from repro.kernels.paged_attention.kernel import (
        paged_attention_chunked_pallas)

    total_kv, depths, pages = saturation.dma_sizes(True, False)
    for bs in pages:
        case = saturation.dma_case(bs, total_kv)
        # the port's allocator lays the BlockList out as the reference's
        lens = case["kv_lens"].tolist()
        nb = case["pool_k"].shape[0]
        al = JAllocator(num_blocks=nb, block_size=bs)
        for r, L in enumerate(lens):
            al.allocate(r, L)
        for got, want in zip(
                (case["block_list"], case["block_req"], case["block_pos"]),
                al.build_block_list(list(range(len(lens))), max_total=nb)):
            np.testing.assert_array_equal(got, np.asarray(want))
        args = [torch.from_numpy(case[k]) for k in saturation.DMA_ARGS]
        first = None
        for depth in depths:
            got = attention_api.paged_attention_chunked_op(
                *args, q_chunk=4, prefetch_depth=depth)
            want = paged_attention_chunked_pallas(
                *[jnp.asarray(case[k]) for k in saturation.DMA_ARGS],
                q_chunk=4, prefetch_depth=depth, interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)
            if first is None:
                first = got
            assert torch.equal(got, first), (bs, depth)
