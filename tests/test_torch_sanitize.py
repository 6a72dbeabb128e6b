"""The port's runtime sanitizers against the JAX package's.

The reference's sanitized smoke (``tools/ci_fast.sh``: reduced smollm-360m
in float32, the overlapped loop, the ``tiered`` eviction policy with 12
host blocks over a 7-block pool) runs on both engines: ``retraces``,
``transfer_guard_trips``, ``invariant_checks`` and ``allowed_host_syncs``
must be equal, and the streams identical.  ``compiles`` counts the port's
kernel builds, none on the CPU.  The guards themselves: a host read of a
reason off the allowlist inside ``no_host_sync`` raises when strict and
counts otherwise; the retrace guard takes the first build of a signature
as warm-up and a later one as a retrace; the allocator checker counts
and raises on a broken invariant."""
import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.serving import engine as jengine
from repro_torch.analysis import sanitize
from repro_torch.config import ServeConfig, get_config
from repro_torch.core import paged_kv
from repro_torch.kernels import build
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine

COUNTERS = ("retraces", "transfer_guard_trips", "invariant_checks",
            "allowed_host_syncs")


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


def _smoke(eng, module, vocab):
    """``tools/ci_fast.sh``'s sanitized workload: three 24-token prompts,
    each twice in a row, two rounds."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, (24,), dtype=np.int32)
               for _ in range(3)]
    rid = 0
    for _ in range(2):
        for p in prompts:
            for _ in range(2):
                eng.submit(module.Request(req_id=rid, prompt=p,
                                          max_new_tokens=4))
                rid += 1
            eng.run_until_done()
    return {r.req_id: list(r.output) for r in eng.finished}


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "sync"])
def test_sanitized_smoke_counters_equal_the_reference(models, overlap):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    kw = dict(kv_block_size=8, max_batch=1, overlap=overlap,
              eviction="tiered", host_blocks=12, sanitize=True)
    ej = jengine.ServingEngine(model_j, params_j, cfg_j,
                               JaxServeConfig(model=cfg_j.name, **kw),
                               num_blocks=7)
    et = tengine.ServingEngine(model_t, params_t, cfg_t,
                               ServeConfig(model=cfg_t.name, **kw),
                               num_blocks=7, device="cpu")
    assert (_smoke(et, tengine, cfg_t.vocab_size)
            == _smoke(ej, jengine, cfg_j.vocab_size))
    sj, st = ej.metrics()["sanitize"], et.metrics()["sanitize"]
    assert st["enabled"] is True
    assert {k: st[k] for k in COUNTERS} == {k: sj[k] for k in COUNTERS}
    assert st["retraces"] == st["transfer_guard_trips"] == 0
    assert st["invariant_checks"] > 0
    assert st["compiles"] == 0                  # nothing is built on a CPU
    if overlap:
        assert st["allowed_host_syncs"] > 0     # tier drains, allowlisted
    pc = et.metrics()["policy_counters"]
    assert all(pc[f"sanitize.{k}"] == st[k] for k in COUNTERS)
    et.alloc.check_invariants(drained=True)


def test_metrics_without_sanitize_report_zeros(models):
    _, (cfg_t, model_t, params_t) = models
    et = tengine.ServingEngine(model_t, params_t, cfg_t,
                               ServeConfig(model=cfg_t.name),
                               num_blocks=8, device="cpu")
    assert et.sanitizer is None
    assert et.metrics()["sanitize"] == {
        "enabled": False, "retraces": 0, "transfer_guard_trips": 0,
        "invariant_checks": 0, "allowed_host_syncs": 0, "compiles": 0}


@pytest.mark.parametrize("strict", [True, False])
def test_a_host_read_off_the_allowlist_trips(strict):
    guard = sanitize.Sanitizer(strict=strict)
    x = torch.arange(4.0)
    with guard.no_host_sync("build"):
        got = sanitize.host_read(x, reason="tier-drain")
        assert torch.equal(got, x)
        if strict:
            with pytest.raises(sanitize.SanitizeError, match="stray"):
                sanitize.host_read(x, reason="stray")
        else:
            assert torch.equal(sanitize.host_read(x, reason="stray"), x)
    c = guard.counters()
    assert c["allowed_host_syncs"] == 1 and c["transfer_guard_trips"] == 1
    assert not guard.clean
    # outside a guarded scope a read only copies
    assert torch.equal(sanitize.host_read(x, reason="stray"), x)
    assert guard.counters()["transfer_guard_trips"] == 1


def test_a_tier_demote_is_an_allowlisted_host_read():
    pool = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    guard = sanitize.Sanitizer()
    with guard.no_host_sync("build"):
        block = paged_kv.read_pool_block(pool, 1)
    assert torch.equal(block, pool[:, 1])
    assert guard.counters()["allowed_host_syncs"] == 1
    with sanitize.Sanitizer(
            host_sync_allowlist={"disagg-handoff"}).no_host_sync("build"):
        with pytest.raises(sanitize.SanitizeError, match="tier-drain"):
            paged_kv.read_pool_block(pool, 0)


@pytest.mark.parametrize("strict", [True, False])
def test_the_retrace_guard_counts_a_second_build(monkeypatch, strict):
    events = [0]
    monkeypatch.setattr(build, "compile_events", lambda: events[0])
    guard = sanitize.Sanitizer(strict=strict)
    sig = sanitize.jit_signature("step", {"a": np.zeros((4, 2), np.int32)},
                                 torch.zeros(3))
    with guard.expect_cached(sig):              # first build: warm-up
        events[0] += 1
    with guard.expect_cached(sig):              # nothing built: cached
        pass
    other = sanitize.jit_signature("step", {"a": np.zeros((8, 2), np.int32)},
                                   torch.zeros(3))
    with guard.expect_cached(other):            # a new shape builds once
        events[0] += 1
    assert guard.counters()["retraces"] == 0
    if strict:
        with pytest.raises(sanitize.SanitizeError, match="retrace"):
            with guard.expect_cached(sig):
                events[0] += 1
    else:
        with guard.expect_cached(sig):
            events[0] += 1
    c = guard.counters()
    assert c["retraces"] == 1 and c["compiles"] == 3


def test_jit_signature_reads_shapes_and_dtypes():
    a = sanitize.jit_signature("t", {"x": torch.zeros((2, 3)), "y": 1})
    b = sanitize.jit_signature("t", {"y": 5, "x": torch.ones((2, 3))})
    c = sanitize.jit_signature("t", {"x": torch.zeros((2, 4)), "y": 1})
    d = sanitize.jit_signature("t", {"x": torch.zeros((2, 3),
                                                      dtype=torch.int32),
                                     "y": 1})
    assert a == b and a != c and a != d and hash(a) == hash(b)


def test_the_allocator_checker_counts_and_raises():
    alloc = paged_kv.BlockAllocator(num_blocks=8, block_size=4)
    alloc.allocate(0, 6)
    guard = sanitize.Sanitizer()
    guard.check_allocator(alloc)
    assert guard.counters()["invariant_checks"] == 1
    alloc._free.append(alloc.table(0)[0])       # a live block also free
    with pytest.raises(sanitize.SanitizeError, match="invariant"):
        guard.check_allocator(alloc)
    assert guard.counters()["invariant_checks"] == 2


def test_no_host_sync_leaves_no_scope_behind():
    guard = sanitize.Sanitizer()
    with pytest.raises(RuntimeError):
        with guard.no_host_sync("build"):
            raise RuntimeError("inside")
    # the scope is gone: a stray read outside it is no trip
    sanitize.host_read(torch.zeros(1), reason="stray")
    assert guard.counters()["transfer_guard_trips"] == 0
