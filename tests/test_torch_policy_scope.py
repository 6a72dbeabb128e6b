"""The port's policy scope (``serving.policy.force_policies`` /
``record_resolutions``) against the reference's: the same sequences of
scopes and ``resolve`` calls give the same names and the same logs,
nested scopes and typo'd names included, and an engine built inside a
scope runs the forced triple."""
import pytest

from repro_torch.serving import policy as tpolicy

TRIPLE = dict(admission="priority", preemption="most-blocks",
              eviction="hit-rate")


def _script(lib):
    """One sequence of scopes and resolutions; returns what it saw."""
    seen = []

    def res(axis, explicit=None, config=None):
        seen.append(("resolve", axis, lib.resolve(axis, explicit,
                                                  config=config).name))

    with lib.record_resolutions() as outer:
        for axis in lib.AXES:
            res(axis)
        with lib.force_policies(admission="priority"):
            seen.append(("forced", lib.forced_policy("admission"),
                         lib.forced_policy("eviction")))
            res("admission")
            res("admission", "deadline-slo")          # explicit wins
            res("admission", config="fcfs")           # scope beats config
            res("eviction", config="hit-rate")        # no scope: config
            with lib.record_resolutions() as inner:
                with lib.force_policies(admission="fcfs",
                                        eviction="refcount-aware"):
                    res("admission")
                    res("eviction")
                    res("preemption")
                res("admission")                      # the outer scope
            seen.append(("inner", list(inner)))
        res("admission")
        seen.append(("forced", lib.forced_policy("admission"), None))
        inst = lib.get("preemption", "fewest-remaining-tokens")()
        res("preemption", inst)
        with lib.force_policies(admission=None, preemption=""):
            res("preemption")
        seen.append(("triple", [p.name for p in lib.resolve_triple(
            eviction="tiered")]))
    seen.append(("outer", list(outer)))
    return seen


def test_scopes_resolve_and_log_as_the_reference():
    from repro.serving import policy as jpolicy

    assert _script(tpolicy) == _script(jpolicy)


@pytest.mark.parametrize("kw", [dict(admission="fifo"),
                                dict(preemption="lru"),
                                dict(eviction="most-blocks")])
def test_typo_names_fail_alike(kw):
    from repro.serving import policy as jpolicy

    errors = []
    for lib in (tpolicy, jpolicy):
        with lib.record_resolutions() as log:
            with pytest.raises(lib.UnknownPolicyError) as e:
                with lib.force_policies(**kw):
                    lib.resolve(next(iter(kw)))
            axis, name = next(iter(kw.items()))
            with pytest.raises(lib.UnknownPolicyError):
                lib.resolve(axis, name)
            with pytest.raises(lib.UnknownPolicyError):
                lib.resolve(axis, config=name)
        errors.append((str(e.value), list(log), lib.forced_policy(axis)))
    assert errors[0] == errors[1]


def test_an_engine_built_in_a_scope_runs_the_forced_triple():
    from repro_torch.bench.llm_e2e import reference_model
    from repro_torch.config import ServeConfig
    from repro_torch.serving.engine import ServingEngine

    cfg, model, params = reference_model("cpu")
    serve = ServeConfig(model=cfg.name, kv_block_size=8, max_batch=2,
                        admission="fcfs")
    with tpolicy.record_resolutions() as log, \
            tpolicy.force_policies(**TRIPLE):
        eng = ServingEngine(model, params, cfg, serve, num_blocks=32,
                            device="cpu")
    assert eng.policies == TRIPLE
    assert sorted(log) == sorted(TRIPLE.items())
    m = eng.metrics()
    assert [m[f"{a}_policy"] for a in tpolicy.AXES] == list(TRIPLE.values())
    # outside the scope the config hint and the defaults come back
    eng = ServingEngine(model, params, cfg, serve, num_blocks=32,
                        device="cpu")
    assert eng.policies == tpolicy.DEFAULTS
    assert tpolicy.forced_policy("admission") is None
