"""The port's serving entry points on the CPU: ``bench.disagg`` at the
reference's smoke sizes against ``benchmarks/disagg.py`` (the same
deterministic counters), the launcher's ``--policy``, ``--roles``,
``--host-blocks``, ``--sanitize``, the kernel tunables' flags and the MoE
configs, and the ``serve_llm`` example with its asserts."""
import numpy as np
import pytest

from repro_torch.bench import disagg as tdisagg
from repro_torch.bench.trace_replay import build
from repro_torch.examples import serve_llm
from repro_torch.launch import serve

# the rows' fields that are host decisions, not times
COUNTERS = ("finished", "handoffs", "prefill_steps", "decode_steps",
            "prefix_hit_rate", "prefix_hits", "evictions", "demotes",
            "promotes", "tier_hits", "drops", "eviction", "roles", "tier")


def _fields(derived):
    kv = dict(f.split("=", 1) for f in derived.split(";"))
    return {k: v for k, v in kv.items() if k in COUNTERS}


def test_bench_disagg_smoke_counters_equal_the_reference(monkeypatch):
    import jax  # noqa: F401  (the reference's benchmark runs on it)
    from benchmarks import common as jcommon
    from benchmarks import disagg as jdisagg

    monkeypatch.setenv("REPRO_BENCH_SMOKE", "1")
    start = len(jcommon.RECORDS)
    jdisagg.run()
    want = jcommon.RECORDS[start:]
    del jcommon.RECORDS[start:]
    cfg, model, params = build("smollm-360m", True, "cpu")
    got = tdisagg.run(model, params, cfg, device="cpu", sizes=tdisagg.SMOKE)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert _fields(g["derived"]) == _fields(w["derived"]), g["name"]
    hits = [float(_fields(r["derived"])["prefix_hit_rate"]) for r in got[2:]]
    assert hits[1] > hits[0]                # tiered beats HBM-only


@pytest.mark.parametrize("argv,expect", [
    (["--policy", "priority/fewest-remaining-tokens/hit-rate"],
     ["policies priority/fewest-remaining-tokens/hit-rate"]),
    (["--policy", "fcfs/latest-arrival/tiered", "--host-blocks", "8"],
     ["role full  tier hbm=", "host=8"]),
    (["--roles", "prefill,decode", "--host-blocks", "4", "--eviction",
      "tiered"],
     ["role prefill,decode", "handoffs 4 ", "served 4 requests"]),
])
def test_launcher_policy_roles_and_host_blocks(capsys, argv, expect):
    serve.main(["--arch", "smollm-360m", "--requests", "4", "--prompt-len",
                "12", "--max-new", "6", "--block-size", "8", "--reduced",
                "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    for e in expect:
        assert e in out, (e, out)


def test_launcher_policy_takes_one_name_or_three():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                    "--policy", "fcfs/lru"])


def test_serve_llm_example_runs_with_its_asserts(capsys):
    serve_llm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "pool leak check: 128 == 128" in out
    assert "policies priority/fewest-remaining-tokens/hit-rate" in out
    assert np.isfinite(float(out.split("(")[1].split(" tok/s")[0]))


_BASE = ["--requests", "4", "--prompt-len", "12", "--max-new", "6",
         "--block-size", "8", "--reduced", "--device", "cpu"]


@pytest.mark.parametrize("argv,expect", [
    (["--sanitize", "on", "--overlap", "on", "--eviction", "tiered",
      "--host-blocks", "4"],
     ["sanitize on  retraces=0 transfer_guard_trips=0 invariant_checks=",
      "compiles=0"]),
    (["--num-queries-per-block", "10", "--num-kv-pages-per-block", "16",
      "--vmem-limit-bytes", "65536"],
     ["num_queries_per_block=10 num_kv_pages_per_block=16 "
      "vmem_limit_bytes=65536", "'tune.tuned_fallback': 0, "
      "'tune.tuned_resolved': 0"]),
    ([], ["sanitize off", "num_queries_per_block=128 "
          "num_kv_pages_per_block=0 vmem_limit_bytes=0",
          "'tune.tuned_fallback': 1"]),
])
def test_launcher_sanitize_and_tunable_flags(capsys, argv, expect):
    serve.main(["--arch", "smollm-360m"] + _BASE + argv)
    out = capsys.readouterr().out
    for e in expect:
        assert e in out, (e, out)


def test_launcher_refuses_a_split_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="num_kv_pages_per_block"):
        serve.main(["--arch", "smollm-360m"] + _BASE
                   + ["--num-kv-pages-per-block", "3"])


@pytest.mark.parametrize("arch,impl", [
    ("granite-moe-1b-a400m", "ragged"), ("granite-moe-1b-a400m", "chunked"),
    ("qwen3-moe-235b-a22b", "ragged")])
def test_launcher_serves_the_moe_configs(capsys, arch, impl):
    serve.main(["--arch", arch, "--attn-impl", impl] + _BASE)
    out = capsys.readouterr().out
    assert "served 4 requests, 24 tokens" in out, out


def test_serve_llm_example_serves_granite_moe(capsys):
    serve_llm.main(["--device", "cpu", "--arch", "granite-moe-1b-a400m"])
    assert "pool leak check: 128 == 128" in capsys.readouterr().out
