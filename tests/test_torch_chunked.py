"""The port's chunked paged attention against the JAX package, on the CPU
in float32: the plain version against the jnp reference and the Pallas
chunked kernel in interpret mode (``prefetch_depth`` 0 and 2), chunked ==
ragged bitwise, the ``attn_impl="chunked"`` engine against the JAX
engine's chunked run, the Fig 17 benchmark's rows, and how
``chip_smoke.py`` reports the ragged and chunked kernels' instances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.core import attention_api as japi
from repro.core import paged_kv as jkv
from repro.kernels.paged_attention.kernel import (
    paged_attention_chunked_pallas)
from repro.models.api import build_model as jax_build_model
from repro.serving import engine as jengine
from repro_torch.bench import paged_attention_bench as bench
from repro_torch.config import ServeConfig, get_config
from repro_torch.core import attention_api as tapi
from repro_torch.core.paged_kv import fused_kv_views
from repro_torch.kernels.paged_attention.cases import (
    ARG_ORDER, CHUNKED_ARG_ORDER, CHUNKED_CASES, SMALL, SMALL_CASES,
    chunked_case, ragged_case)
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine


def _case(name, seed=0):
    return chunked_case(np.random.default_rng(seed), **SMALL,
                        **CHUNKED_CASES[name])


def _torch_args(c):
    pk, pv = fused_kv_views(torch.from_numpy(c["kv_pool"]))
    return [torch.from_numpy(c["q"]), pk, pv,
            *[torch.from_numpy(c[k]) for k in CHUNKED_ARG_ORDER]]


def _jax_args(c):
    pk, pv = jkv.fused_kv_views(jnp.asarray(c["kv_pool"]))
    return [jnp.asarray(c["q"]), pk, pv,
            *[jnp.asarray(c[k]) for k in CHUNKED_ARG_ORDER]]


@pytest.mark.parametrize("name", sorted(CHUNKED_CASES))
def test_plain_chunked_matches_jax_reference(name):
    c = _case(name)
    got = tapi.paged_attention_chunked(*_torch_args(c)).numpy()
    want = np.asarray(japi.paged_attention_chunked(*_jax_args(c)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    kvl = np.append(c["kv_lens"], 0)
    dead = kvl[np.minimum(c["token_req"], len(c["kv_lens"]))] == 0
    assert dead.any() and np.all(got[dead] == 0)


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("name", sorted(CHUNKED_CASES))
def test_chunked_op_on_cpu_matches_pallas_interpret(name, depth):
    c = _case(name, seed=1)
    before = tapi.paged_attention_chunked_op.launches
    got = tapi.paged_attention_chunked_op(*_torch_args(c), q_chunk=4,
                                          prefetch_depth=depth).numpy()
    assert tapi.paged_attention_chunked_op.launches == before  # CPU: plain
    want = np.asarray(paged_attention_chunked_pallas(
        *_jax_args(c), q_chunk=4, prefetch_depth=depth, interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_chunked_op_refuses_bad_tunables():
    args = _torch_args(_case("runs"))
    with pytest.raises(ValueError, match="q_chunk"):
        tapi.paged_attention_chunked_op(*args, q_chunk=0)
    with pytest.raises(ValueError, match="prefetch_depth"):
        tapi.paged_attention_chunked_op(*args, prefetch_depth=-1)


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_chunked_equals_ragged_bitwise(name):
    c = ragged_case(np.random.default_rng(0),
                    **dict(SMALL, **SMALL_CASES[name]))
    q, pool, bl, br, bp, cu_q, cu_kv, ss = [torch.from_numpy(c[k])
                                            for k in ARG_ORDER]
    ragged = tapi.paged_attention_ragged_op(q, pool, bl, br, bp, cu_q, cu_kv,
                                            ss)
    treq, tpos, kvl = tapi.ragged_lane_metadata(cu_q, cu_kv, ss, q.shape[0],
                                                ss.shape[0])
    chunked = tapi.paged_attention_chunked_op(q, *fused_kv_views(pool), bl,
                                              br, bp, kvl, treq, tpos)
    assert torch.equal(ragged, chunked)


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_get_config("smollm-360m").reduced(dtype="float32")
    model_j = jax_build_model(cfg_j, remat=False)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config("smollm-360m").reduced(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    return (cfg_j, model_j, params_j), (cfg_t, model_t, params_t)


def _run(engine_mod, model, params, cfg, serve, num_blocks, **kw):
    eng = engine_mod.ServingEngine(model, params, cfg, serve,
                                   num_blocks=num_blocks, **kw)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, (12,), dtype=np.int32)
    prompts = [shared, rng.integers(0, cfg.vocab_size, (9,), dtype=np.int32),
               rng.integers(0, cfg.vocab_size, (14,), dtype=np.int32),
               shared.copy()]
    for i, p in enumerate(prompts):
        eng.submit(engine_mod.Request(req_id=i, prompt=p, max_new_tokens=6,
                                      arrival=float(i)))
    eng.run_until_done()
    return {r.req_id: list(r.output) for r in eng.finished}, eng.metrics()


_COUNTERS = ("steps", "preemptions", "prefix_hits", "prefix_misses",
             "cow_copies", "output_tokens", "slot_compactions")


@pytest.mark.parametrize("num_blocks", [64, 10])       # roomy, starved
def test_chunked_engine_matches_jax_chunked_engine(models, num_blocks):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    kw = dict(kv_block_size=4, max_batch=4, prefill_chunk=8,
              attn_impl="chunked")
    out_j, mj = _run(jengine, model_j, params_j, cfg_j,
                     JaxServeConfig(model=cfg_j.name, **kw), num_blocks)
    out_t, mt = _run(tengine, model_t, params_t, cfg_t,
                     ServeConfig(model=cfg_t.name, **kw), num_blocks,
                     device="cpu")
    assert out_t == out_j
    for key in _COUNTERS + ("attn_impl", "q_chunk", "prefetch_depth"):
        assert mt[key] == mj[key], key
    assert mt["attn_impl"] == "chunked"
    if num_blocks == 10:
        assert mt["preemptions"] > 0
    # the port's ragged engine gives the same streams
    out_r, mr = _run(tengine, model_t, params_t, cfg_t,
                     ServeConfig(model=cfg_t.name, **dict(
                         kw, attn_impl="ragged")), num_blocks, device="cpu")
    assert out_r == out_t and mr["steps"] == mt["steps"]


def test_decode_tokens_paged_refuses_an_unknown_attn_impl(models):
    _, (cfg_t, model_t, params_t) = models
    with pytest.raises(ValueError, match="attn_impl"):
        model_t.decode_tokens_paged(params_t, {}, {}, torch.zeros(1),
                                    attn_impl="flash")


def test_fig17_bytes_ratio_grows_with_padding():
    rows = bench.padding_sweep(torch.device("cpu"), B=4, BS=4, KV=2, HD=16,
                               H=4, full_blocks=8)
    opt = [r for r in rows if r["name"].startswith("paged_opt_pad")]
    assert [r["frac"] for r in opt] == list(bench.PAD_FRACS)
    ratios = [r["bytes_ratio"] for r in opt]
    assert ratios == sorted(ratios) and ratios[0] == pytest.approx(1.0,
                                                                   abs=0.01)
    assert ratios[-1] > 4
    assert all("device=cpu" in r["derived"] and r["kernel_ms"] is None
               for r in opt)


def test_fig17_benchmark_runs_every_sweep_on_the_cpu():
    rows = bench.run("cpu", quick=True)
    names = [r["name"] for r in rows]
    assert sum(n.startswith("paged_opt_pad") for n in names) == 4
    assert [n for n in names if n.startswith("paged_opt_B")] == [
        "paged_opt_B8_S128", "paged_opt_B32_S256"]
    chunked = [r for r in rows if r["name"].startswith("paged_chunked_C")]
    assert [r["chunk"] for r in chunked] == [1, 4, 16]
    layout = [r for r in rows if r["name"].startswith("ragged_layout")]
    assert len(layout) == 2 and all(r["bitwise"] for r in layout)


PAGED_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__b3049054_25_paged_attention_ragged_cu_8e0fe10023ragged_attention_kernelI13__nv_bfloat16Li64EEEvPKT_S4_PS2_PKiS7_S7_S7_S7_iiiiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 125 registers, used 1 barriers, 9648 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__b3049054_25_paged_attention_ragged_cu_8e0fe10023ragged_attention_kernelI13__nv_bfloat16Li16EEEvPKT_S4_PS2_PKiS7_S7_S7_S7_iiiiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers, 9616 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__b3049054_25_paged_attention_ragged_cu_8e0fe10018entry_lists_kernelEPKiS1_S1_iS1_S1_S1_iiiPiS2_S2_' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 37 registers, used 1 barriers, 128 bytes smem
ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__b3049054_25_paged_attention_ragged_cu_8e0fe10023ragged_attention_kernelIfLi64EEEvPKT_S3_PS1_PKiS6_S6_S6_S6_iiiiiiiif' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 4880 bytes smem
"""


def test_chip_smoke_reads_each_paged_instance_and_fails_on_a_spill():
    """``chip_smoke.py``'s phases 6 and 18 name each ragged or chunked
    instance's tiles (SIMT and the decode tile, beside wgmma or mma.sync in
    bf16) from the ``-Xptxas -v`` log, add its dynamic shared memory, skip
    the list kernels, and fail on a spill (the f32 entry of the sample log
    spills)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def smem(hd, dtype):
        return 1000 * hd + dtype

    bf16_log = PAGED_PTXAS_LOG[:PAGED_PTXAS_LOG.index(
        "ptxas info    : Compiling entry function '_ZN58_GLOBAL__N__b3049054"
        "_25_paged_attention_ragged_cu_8e0fe10023ragged_attention_kernelIf")]
    rows = smoke.ptxas_instances("ragged_attention_kernel", smem, bf16_log,
                                 build, "card", smoke.paged_tile)
    assert rows == [
        dict(dtype="bfloat16", hd=64, tile="SIMT + decode + wgmma",
             registers=125, smem_static=9648, smem_dynamic=64001),
        dict(dtype="bfloat16", hd=16, tile="SIMT + decode + mma.sync",
             registers=110, smem_static=9616, smem_dynamic=16001)]
    with pytest.raises(AssertionError, match="float32, 64> spills"):
        smoke.ptxas_instances("ragged_attention_kernel", smem,
                              PAGED_PTXAS_LOG, build, "card",
                              smoke.paged_tile)
    with pytest.raises(AssertionError, match="no chunked_attention_kernel"):
        smoke.ptxas_instances("chunked_attention_kernel", smem,
                              PAGED_PTXAS_LOG, build, "card",
                              smoke.paged_tile)
