"""The port's overlapped engine loop against its serial loop and against the
JAX package's engine, on the same submits: reduced smollm-360m, float32,
bridged parameters, ``device="cpu"`` (the cases of the reference's
``tests/test_overlap.py``).  Greedy streams must be identical in every
case, with the pipeline and the pool drained."""
import jax
import numpy as np
import pytest

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.serving import engine as jengine
from repro_torch.config import ServeConfig, get_config
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving import engine as tengine

_COUNTERS = ("steps", "preemptions", "prefix_hits", "prefix_misses",
             "cow_copies", "output_tokens", "slot_compactions")


@pytest.fixture(scope="module")
def env():
    cfg_j = jget_config("smollm-360m").reduced(dtype="float32")
    model_j = jbuild_model(cfg_j, remat=False)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config("smollm-360m").reduced(dtype="float32")
    model_t = build_model(cfg_t, device="cpu")
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg_t.vocab_size, (4,), dtype=np.int32)
    prompts = [np.concatenate([prefix,
                               rng.integers(0, cfg_t.vocab_size, (2 + i,),
                                            dtype=np.int32)])
               for i in range(4)]

    def run(port, overlap, *, spec="off", num_blocks=48, max_batch=4,
            eos_id=-1, chained=None):
        mod, serve_cls, (cfg, model, params) = (
            (tengine, ServeConfig, (cfg_t, model_t, params_t)) if port else
            (jengine, JServeConfig, (cfg_j, model_j, params_j)))
        serve = serve_cls(model=cfg.name, kv_block_size=4,
                          max_batch=max_batch, spec=spec, spec_k=3,
                          overlap=overlap)
        kw = dict(device="cpu") if port else {}
        eng = mod.ServingEngine(model, params, cfg, serve,
                                num_blocks=num_blocks, eos_id=eos_id, **kw)
        if chained is not None:         # count the lanes fed from the card
            render = eng._render

            def counting(plan):
                out = render(plan)
                chained.append(int((np.asarray(out[2]) >= 0).sum()))
                return out
            eng._render = counting
        for i, p in enumerate(prompts):
            eng.submit(mod.Request(req_id=i, prompt=p, max_new_tokens=10))
        eng.run_until_done()
        return eng

    return run


def _streams(eng):
    return {r.req_id: list(r.output) for r in eng.finished}


def _check(run, **kw):
    """Port overlap on == port overlap off == JAX overlap on, streams and
    counters; the port's pipeline and pool drained."""
    serial = run(True, False, **kw)
    ov = run(True, True, **kw)
    ref = run(False, True, **kw)
    assert _streams(ov) == _streams(serial) == _streams(ref)
    mo, mr = ov.metrics(), ref.metrics()
    for key in _COUNTERS:
        assert mo[key] == mr[key], key
    assert mo["overlap"] is True and serial.metrics()["overlap"] is False
    assert ov._pending is None and not ov._chain
    assert ov.alloc.num_free == ov.alloc.num_blocks
    assert len(ov.finished) == 4
    ov.alloc.check_invariants(drained=True)
    return serial, ov, ref


def test_overlap_greedy_parity_base(env):
    _check(env)
    # the loop really overlapped: every decode lane after the first step
    # took its input token from the step still in flight
    chained = []
    ov = env(True, True, chained=chained)
    assert sum(chained) >= ov.metrics()["output_tokens"] - 2 * 4
    assert chained[0] == 0


def test_overlap_parity_under_preemption_mid_flight(env):
    _, ov, _ = _check(env, num_blocks=8, max_batch=3)
    assert ov.metrics()["preemptions"] > 0


def test_overlap_parity_with_spec_rollback(env):
    serial, ov, ref = _check(env, spec="ngram", num_blocks=8, max_batch=3)
    for e in (serial, ov):
        c = e._spec_counters
        assert c["drafted_steps"] > 0
        assert c["proposed_tokens"] > c["accepted_tokens"]
    assert ov.metrics()["spec"] == ref.metrics()["spec"]


def test_overlap_parity_with_eos(env):
    eos = next(iter(_streams(env(True, False)).values()))[1]
    serial, _, _ = _check(env, eos_id=eos)
    assert any(len(s) < 10 for s in _streams(serial).values())


def test_overlap_idle_tick_is_counted(env):
    ov = env(True, True)
    steps = ov.metrics()["steps"]
    assert ov.step() == 0
    m = ov.metrics()
    assert m["num_idle_steps"] == 1 and m["steps"] == steps
    assert "idle" in m["phase_s"]
