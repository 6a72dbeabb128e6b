"""The port's harness sweeps (``bench.run --policy`` / ``--spec``) on the
CPU, with stub modules for speed: a typo'd triple or proposer exits
before any module runs, only the policy- and proposer-sensitive modules
repeat, every JSON row carries the resolved triple, proposer and
``sanitize`` stamps with the schema version and commit, ``--backend`` and
``--devices`` are refused, and a CPU ``recsys_e2e`` row has no energy
reading."""
import json

import pytest

from repro_torch.bench import recsys_e2e
from repro_torch.bench import run as harness
from repro_torch.perf.table import SCHEMA_VERSION
from repro_torch.serving import policy as policy_lib
from repro_torch.serving import spec as spec_lib

TRIPLES = "fcfs/latest-arrival/lru,priority/most-blocks/hit-rate"


@pytest.fixture
def calls(monkeypatch):
    """Stub modules that resolve a triple and a proposer as an engine
    does, and record the scope each ran under."""
    seen = []

    def stub(name):
        def run(dev, full):
            seen.append((name, policy_lib.forced_policy("admission"),
                         spec_lib.forced_proposer()))
            triple = policy_lib.resolve_triple()
            spec_lib.resolve()
            return [{"name": f"{name}_row", "ms": 1.0,
                     "derived": "policies=" + "/".join(
                         p.name for p in triple)}]
        return run

    monkeypatch.setattr(harness, "runner", stub)
    return seen


def test_a_typo_exits_before_any_module_runs(calls):
    for flag, value in (("--policy", "fcfs/lates-arrival/lru"),
                        ("--policy", "fcfs/lru"),
                        ("--spec", "off,ngrm")):
        with pytest.raises(SystemExit, match=flag):
            harness.main(["--device", "cpu", "--only", "llm_e2e",
                          flag, value])
    assert calls == []


def test_only_sensitive_modules_repeat_and_rows_are_stamped(
        calls, monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    out = tmp_path / "sweep.json"
    harness.main(["--device", "cpu", "--only", "llm_e2e,saturation,stream",
                  "--policy", TRIPLES, "--spec", "off,ngram",
                  "--json", str(out)])
    assert calls == [
        ("llm_e2e", "fcfs", "off"), ("saturation", "fcfs", "off"),
        ("stream", "fcfs", "off"), ("llm_e2e", "fcfs", "ngram"),
        ("llm_e2e", "priority", "off"), ("saturation", "priority", "off"),
        ("llm_e2e", "priority", "ngram")]
    results = json.loads(out.read_text())
    assert len(results) == len(calls)
    for res, (mod, adm, spec) in zip(results, calls):
        assert res["module"] == mod
        assert res["schema_version"] == SCHEMA_VERSION
        assert res["git_commit"] and res["device"] == "cpu"
        assert res["requested_spec"] == spec
        triple = res["requested_policy"]
        assert triple.startswith(adm)
        for row in res["rows"]:
            assert row["policy"] == triple
            assert row["derived"] == f"policies={triple}"
            assert row["spec"] == spec
            assert row["sanitize"] is True


@pytest.mark.parametrize("flag", ["--backend", "--devices"])
def test_refused_flags(calls, flag):
    with pytest.raises(SystemExit, match="not ported"):
        harness.main(["--device", "cpu", f"{flag}=1,2"])
    with pytest.raises(SystemExit, match=harness.REFUSED[flag][:20]):
        harness.main(["--device", "cpu", flag, "ref"])
    assert calls == []


def test_the_harness_lists_the_new_modules():
    assert {"llm_e2e", "saturation", "disagg", "trace_replay"} <= set(
        harness.MODULES)
    assert harness.POLICY_SENSITIVE == {"llm_e2e", "saturation", "disagg"}
    assert harness.SPEC_SENSITIVE == {"llm_e2e"}


def test_cpu_recsys_row_has_no_energy():
    rows = recsys_e2e.run("cpu", rows=64, batches=(16,), energy=True,
                          archs=("rm2",))
    assert len(rows) == 2
    for r in rows:
        assert "energy_uJ_per_inf" not in r and "watts" not in r
        assert "energy" not in r["derived"]


def test_the_new_entry_points_default_to_the_card(monkeypatch):
    import torch

    from repro_torch.bench import llm_e2e, saturation

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (llm_e2e.run, saturation.run):
        with pytest.raises(RuntimeError, match="cuda"):
            fn()
    with pytest.raises(RuntimeError, match="cuda"):
        harness.main(["--only", "llm_e2e"])
