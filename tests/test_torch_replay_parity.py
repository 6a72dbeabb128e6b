"""The slice as a whole: the port's trace-replay sweep
(``repro_torch.bench.trace_replay``) against the JAX package's, on the
CPU, reduced float32 smollm-360m with the reference's weights.

* the ``mixed`` scenario's seven single-device rows equal a live run of the
  reference's sweep, field for field (every ``derived`` key, ``resolved``
  included; only the wall time ``us_per_call`` differs);
* all 28 single-device rows of the committed ``BENCH_009.json`` equal the
  port's, except the rows in :data:`CAVEATS`, which the JAX package at this
  commit does not reproduce either (ROADMAP queue C): those are held to a
  live reference run of the same configuration instead;
* the regression gate of both packages passes on the port's rows against
  ``BENCH_009.json`` with the caveat rows taken from the live run;
* ``ngram`` under ``attn_impl="chunked"`` gives its ragged twin's streams;
* the committed weights file is the JAX model's ``init(PRNGKey(0))``.

Run as a script (``python tests/test_torch_replay_parity.py``) it rewrites
that weights file from the JAX model."""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import benchmarks.trace_replay as jtr
from repro.config import get_config as jget_config
from repro.models.api import build_model as jbuild_model
from repro.perf import gate as jgate
from repro.perf.table import PerfTable as JPerfTable
from repro.perf.trace import LengthModel as JLengthModel
from repro.perf.trace import generate as jgenerate
from repro_torch.bench import trace_replay as ttr
from repro_torch.perf import gate as tgate

BENCH = Path(__file__).resolve().parents[1] / "BENCH_009.json"
CAVEATS = ttr.REFERENCE_CAVEATS         # the ngram rows: ROADMAP queue C


def _jax_model():
    cfg = jget_config("smollm-360m").reduced(dtype="float32")
    model = jbuild_model(cfg, remat=False)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _jax_rows(jax_model, scenario, labels):
    """The reference sweep's rows for ``labels`` on ``scenario``, live:
    name -> derived dict (the auto row against the table of the fixed rows
    run here, as the reference builds it)."""
    cfg, model, params = jax_model
    p = jtr.SCENARIOS[scenario]
    trace = jgenerate(scenario, seed=p["seed"], n_requests=p["n_requests"],
                      vocab_size=cfg.vocab_size, **jtr.TRACE_KWARGS)
    lm = JLengthModel.fit(trace)
    rows, fixed = {}, []
    for label, triple, spec, overlap, devices in jtr.CONFIGS:
        if devices > 1 or label not in labels:
            continue
        table = JPerfTable(fixed) if label == "auto" else None
        _, result, report, _ = jtr._run_one(
            model, params, cfg, scenario, trace, p["slo"], triple, spec,
            overlap, devices, table=table, length_model=lm)
        name, derived = jtr._row(scenario, label, trace, triple, spec,
                                 overlap, devices, result, report)
        if label == "auto":
            winner = table.winner(scenario)
            derived += ";resolved=" + "/".join(winner[a] for a in
                                               ("admission", "preemption",
                                                "eviction"))
        else:
            fixed.append(dict(ttr.parse_derived(derived), name=name))
        rows[name] = ttr.parse_derived(derived)
    return rows


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


@pytest.fixture(scope="module")
def port_rows():
    cfg, model, params = ttr.build("smollm-360m", True, "cpu")
    records = ttr.sweep(model, params, cfg, device="cpu", log=lambda _: None)
    return records


@pytest.fixture(scope="module")
def live(jax_model):
    """The live reference rows: mixed's seven, and every caveat row."""
    labels = [c[0] for c in ttr.CONFIGS]
    rows = _jax_rows(jax_model, "mixed", labels)
    for scenario in ttr.SCENARIOS:
        if scenario != "mixed":
            rows.update(_jax_rows(jax_model, scenario, ["ngram"]))
    return rows


def test_weights_file_is_the_reference_init(jax_model):
    want = _flat(jax_model[2])
    with np.load(ttr.REFERENCE_WEIGHTS) as f:
        assert sorted(f.files) == sorted(want)
        for k in f.files:
            assert f[k].dtype == want[k].dtype
            np.testing.assert_array_equal(f[k], want[k])


def test_mixed_rows_match_the_live_reference(port_rows, live):
    mixed = {r["name"]: ttr.parse_derived(r["derived"]) for r in port_rows
             if r["name"].startswith("trace_mixed_")}
    assert len(mixed) == 7
    for name, row in mixed.items():
        assert row == live[name], name
    assert mixed["trace_mixed_auto"]["resolved"] == \
        "deadline-slo/most-blocks/refcount-aware"


def _bench_rows():
    with open(BENCH) as f:
        return {r["name"]: ttr.parse_derived(r["derived"])
                for r in json.load(f)[0]["rows"]
                if ttr.parse_derived(r["derived"])["devices"] == "1"}


def test_all_rows_match_bench_009_or_a_logged_caveat(port_rows, live):
    bench = _bench_rows()
    port = {r["name"]: ttr.parse_derived(r["derived"]) for r in port_rows}
    assert sorted(port) == sorted(bench) and len(port) == 28
    for name in port:
        if name in CAVEATS:
            assert live[name] != bench[name], f"{name}: no longer a caveat"
            assert port[name] == live[name], name
        else:
            assert port[name] == bench[name], name
    assert port["trace_bursty_fcfs"]["steps"] == "44"
    assert (port["trace_mixed_edf"]["prefix_hits"],
            port["trace_mixed_edf"]["preempt"]) == ("22", "7")


def test_both_gates_pass_against_bench_009(port_rows, live, tmp_path,
                                           capsys):
    assert ttr.BENCH_009 == BENCH
    base = ttr.baseline({name: ";".join(f"{k}={v}" for k, v in
                                        live[name].items())
                         for name in CAVEATS})
    (tmp_path / "base.json").write_text(json.dumps(base))
    (tmp_path / "pt.json").write_text(json.dumps(ttr.to_json(port_rows)))
    argv = ["--baseline", str(tmp_path / "base.json"), "--current",
            str(tmp_path / "pt.json")]
    assert tgate.main(argv) == 0
    assert jgate.main(argv) == 0
    assert "compared 28 pinned rows" in capsys.readouterr().out


def test_ngram_chunked_streams_equal_ragged(port_rows):
    cfg, model, params = ttr.build("smollm-360m", True, "cpu")
    trace = ttr.trace_of("mixed", cfg.vocab_size)
    config = next(c for c in ttr.CONFIGS if c[0] == "ngram")
    _, result, report, _ = ttr.run_one(
        model, params, cfg, "mixed", trace, config, table=None,
        length_model=None, device="cpu", attn_impl="chunked")
    ragged = next(r for r in port_rows if r["name"] == "trace_mixed_ngram")
    assert result.outputs == ragged["outputs"]
    assert ttr.derived_of("mixed", config, trace, result, report) == \
        ragged["derived"]
    assert ragged["metrics"]["spec"]["drafted_steps"] > 0


if __name__ == "__main__":
    np.savez(sys.argv[1] if len(sys.argv) > 1 else ttr.REFERENCE_WEIGHTS,
             **_flat(_jax_model()[2]))
