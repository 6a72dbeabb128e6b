"""The mesh-native serving engine of the port, on the CPU over gloo ranks:
the reference's acceptance sweep (``tests/test_sharded_engine.py``
``_SWEEP``: two policy triples x proposers off / ngram x a roomy and a
tight pool, reduced smollm-360m in float32 with the reference's weights)
at S = 2 (ragged and chunked) and S = 4 (ragged), one spawn each, and its
copy-on-write / prefix-cache case, also with the copy across ranks.

Every rank's greedy streams must equal the port's single-rank engine's and
the JAX package's single-device engine's, token for token; the ranks must
agree; ``metrics()`` must report ``backend == "sharded"``, ``devices`` and
``mesh_shape``, carry the reference's keys, and equal the single-device
engine's on every field that is not wall clock.  Also ``--devices 2``
through ``repro_torch.launch.serve`` and the trace replay's ``dev2`` row.
"""
import jax
import numpy as np
import pytest

from repro.config import ServeConfig as JServeConfig
from repro.config import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.serving import engine as jengine
from repro_torch.bench import sharded
from repro_torch.bench import trace_replay as ttr
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve

# metrics that are wall clock, or name the mesh the run had
WALL = ("mean_ttft_s", "p50_ttft_s", "p90_ttft_s", "p99_ttft_s",
        "mean_tpot_s", "p50_tpot_s", "p90_tpot_s", "p99_tpot_s",
        "throughput_tok_s", "phase_s")
MESH = ("backend", "devices", "mesh_shape")


def _jax_run(model, params, cfg, spec, triple, nb):
    adm, pre, evi = triple
    eng = jengine.ServingEngine(
        model, params, cfg,
        JServeConfig(model=cfg.name, kv_block_size=4, max_batch=3,
                     admission=adm, preemption=pre, eviction=evi,
                     spec=spec, spec_k=3), num_blocks=nb)
    for r in sharded.sweep_requests(cfg.vocab_size):
        eng.submit(jengine.Request(deadline=None, **r))
    eng.run_until_done()
    return {r.req_id: list(map(int, r.output)) for r in eng.finished}, \
        eng.metrics()


def _jax_cow(model, params, cfg, steps):
    eng = jengine.ServingEngine(
        model, params, cfg,
        JServeConfig(model=cfg.name, kv_block_size=4, max_batch=2),
        num_blocks=64)
    prefix = np.random.default_rng(0).integers(0, cfg.vocab_size, (12,),
                                               dtype=np.int32)
    eng.submit(jengine.Request(req_id=0, prompt=prefix.copy(),
                               max_new_tokens=8))
    for _ in range(steps):
        eng.step()
    eng.submit(jengine.Request(req_id=1, prompt=prefix.copy(),
                               max_new_tokens=6))
    eng.run_until_done()
    m = eng.metrics()
    return ({r.req_id: list(map(int, r.output)) for r in eng.finished},
            (m["cow_copies"], m["prefix_hits"]))


@pytest.fixture(scope="module")
def reference():
    """The JAX single-device engine over the sweep and both cow cases."""
    cfg = jget_config(sharded.ARCH).reduced(dtype="float32")
    model = jbuild_model(cfg, remat=False)
    params = model.init(jax.random.PRNGKey(0))
    runs = [_jax_run(model, params, cfg, spec, triple, nb)
            for spec, triple, nb in sharded.cases()]
    return dict(runs=runs,
                cow=_jax_cow(model, params, cfg, 3),
                cow_cross=_jax_cow(model, params, cfg,
                                   sharded.COW_CROSS_STEPS))


@pytest.fixture(scope="module")
def single():
    return sharded.sweep_job(False, "cpu", "reference",
                             ("ragged", "chunked"))


def _counters(m):
    return {k: v for k, v in m.items() if k not in WALL + MESH}


def _check(ranks, single, reference, S, impls):
    cases = sharded.cases()
    for rank in ranks:
        assert len(rank["runs"]) == len(impls) * len(cases)
        for i, run in enumerate(rank["runs"]):
            j = i % len(cases)
            spec = cases[j][0]
            want, want_m = reference["runs"][j]
            assert run["outputs"] == single["runs"][i]["outputs"] == want, \
                run["case"]
            assert run["outputs"] == ranks[0]["runs"][i]["outputs"]
            m = run["metrics"]
            assert m["backend"] == "sharded"
            assert m["devices"] == S and m["mesh_shape"] == {"data": 1,
                                                             "model": S}
            assert m["finished"] == 4
            assert set(m) == set(want_m), run["case"]
            assert _counters(m) == _counters(
                single["runs"][i]["metrics"]), run["case"]
            if spec == "ngram":
                assert m["spec"]["proposer"] == "ngram"
                assert m["spec"]["drafted_steps"] > 0
        for key in ("cow", "cow_cross"):
            got = rank[key]
            outs, (cow, hits) = reference[key]
            assert got["outputs"] == single[key]["outputs"] == outs, key
            m = got["metrics"]
            assert (m["cow_copies"], m["prefix_hits"]) == (cow, hits)
            assert cow > 0 and hits > 0
            assert _counters(m) == _counters(single[key]["metrics"])
        assert rank["cow_cross"]["cow_moves"] > 0


def test_sharded_engine_on_two_ranks(single, reference):
    impls = ("ragged", "chunked")
    ranks = mesh_lib.run_ranks(sharded.sweep_job, 2,
                               (True, "cpu", "reference", impls))
    _check(ranks, single, reference, 2, impls)


def test_sharded_engine_on_four_ranks(single, reference):
    ranks = mesh_lib.run_ranks(sharded.sweep_job, 4, (True, "cpu"))
    _check(ranks, single, reference, 4, ("ragged",))
    assert ranks[0]["cow"]["cow_moves"] > 0


def test_single_rank_metrics_keys_equal_the_reference(single, reference):
    for run, (_, want_m) in zip(single["runs"], reference["runs"] * 2):
        assert set(run["metrics"]) == set(want_m)
        assert run["metrics"]["mesh_shape"] is None
        assert run["metrics"]["devices"] == 1


def test_every_projection_split_on_two_ranks():
    """Reduced llama31-8b with 4 q heads over 2 kv heads: wq / wk / wv
    gathered in one collective, wo and w_down row-parallel, the embedding
    and the untied head vocabulary-parallel; streams and counters equal
    one rank's."""
    single = sharded.tp_job(False)
    ranks = mesh_lib.run_ranks(sharded.tp_job, 2, (True,))
    for rank in ranks:
        assert rank["split"] == ["wq", "wk", "wv", "wo", "w_gate", "embed",
                                 "head"]
        for got, want in zip(rank["runs"], single["runs"]):
            assert got["outputs"] == want["outputs"]
            assert _counters(got["metrics"]) == _counters(want["metrics"])
    assert single["runs"][1]["metrics"]["spec"]["drafted_steps"] > 0


def test_launcher_devices_2(capsys):
    args = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
            "--requests", "3", "--prompt-len", "12", "--max-new", "5",
            "--block-size", "4"]
    one = serve.main(args)
    two = serve.main(args + ["--devices", "2"])
    out = capsys.readouterr().out
    assert "attention=sharded device=cpu devices=2 mesh={'data': 1, " \
           "'model': 2}" in out
    assert two["outputs"] == one["outputs"] and len(one["outputs"]) == 3
    assert two["metrics"]["steps"] == one["metrics"]["steps"]


def test_bench_run_devices_sweep(monkeypatch):
    """``bench.run --devices 1,2``: a pass on one rank and one on two, every
    record and row stamped, the two-rank rows served sharded, and every
    field that is not a time, the backend or the count equal."""
    from repro_torch.bench import llm_e2e
    from repro_torch.bench import run as harness

    monkeypatch.setenv("REPRO_BENCH_SMOKE", "1")
    recs = harness.main(["--device", "cpu", "--only", "llm_e2e",
                         "--devices", "1,2"])
    assert [r["devices"] for r in recs] == [1, 2]
    one, two = ([llm_e2e.counters(row) for row in r["rows"]] for r in recs)
    assert all(row["devices"] == r["devices"] for r in recs
               for row in r["rows"])
    engine_rows = [c for c in two if "devices" in c]
    assert engine_rows and all(c["devices"] == "2" for c in engine_rows)
    assert all("backend=sharded" in row["derived"]
               for row in recs[1]["rows"] if "backend=" in row["derived"])
    def drop(c):
        return {k: v for k, v in c.items() if k != "devices"}

    assert [drop(c) for c in one] == [drop(c) for c in two]


def test_dev2_replay_row_parity_keys_equal_fcfs():
    cfg, model, params = ttr.build("smollm-360m", True, "cpu")
    scenario = "shared-prefix"
    trace = ttr.trace_of(scenario, cfg.vocab_size)
    fcfs = ttr.CONFIGS[0]
    _, result, report, _ = ttr.run_one(
        model, params, cfg, scenario, trace, fcfs, table=None,
        length_model=ttr.LengthModel.fit(trace), device="cpu")
    derived = ttr.derived_of(scenario, fcfs, trace, result, report)
    rec = ttr.dev2_record("smollm-360m", True, scenario, "cpu", derived)
    row, twin = (ttr.parse_derived(rec["derived"]),
                 ttr.parse_derived(derived))
    assert rec["name"] == "trace_shared-prefix_dev2"
    assert row["devices"] == "2" and twin["devices"] == "1"
    assert {k: row[k] for k in ttr.PARITY_KEYS} == {
        k: twin[k] for k in ttr.PARITY_KEYS}
    assert int(row["prefix_hits"]) > 0
    assert rec["outputs"] == result.outputs
    assert rec["metrics"]["backend"] == "sharded"
