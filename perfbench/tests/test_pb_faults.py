"""The served comparison on the CPU at a tiny size, in float32 (where the
port's tokens are the reference's exactly): the reference follows the
port's forward, a sound run is correct, and each fault a serving cell can
have makes ``correct`` false: the KV pool left unchanged by a step, half
of the batch left out, a token altered where it is produced.  (One card,
so no exchange between chips to leave out.)"""
import time

import pytest
import torch

from perfbench.harness import model, spec
from perfbench.reference import transformer as reference
from perfbench.systems import serve

from .conftest import DATA

MIX = spec.load_json(DATA / "tiny_mix.json")
GEN = spec.load_module(spec.PACKAGE / "traffic" / "closed_loop.py", "traffic")
CONFIGS = ["tiny_moe.json", "tiny_dense.json"]


def _run(config, seed=2 ** 31 + 99):
    return serve.run(spec.load_json(DATA / config), MIX, GEN, seed=seed,
                     seconds=1.5, trace=False, device="cpu",
                     t_start=time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_follows_the_ports_forward(config):
    import dataclasses

    from repro_torch.models.transformer import TransformerLM

    c = dict(spec.load_json(DATA / config), dtype="float32")
    d = model.dims(c)
    w = model.draw(d, 5, torch.device("cpu"))
    cfg = serve.port_config(c, d)
    if cfg.moe is not None:     # no token dropped, as the serving path runs
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=d.experts / d.top_k))
    tokens = torch.randint(0, d.vocab, (1, 24),
                           generator=torch.Generator().manual_seed(0))
    got = TransformerLM(cfg, device="cpu").forward(w, tokens)[0][0]
    want = reference.logits(w, d, tokens[0], torch.arange(24))
    assert torch.allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("config", CONFIGS)
def test_sound_run_is_correct(config):
    out = _run(config)
    assert out.correct, out.checks
    assert out.failed == 0


def _state_unchanged(monkeypatch):
    from repro_torch.core import paged_kv

    monkeypatch.setattr(paged_kv, "append_to_pool",
                        lambda pool, kv, slots, n=None: pool)


def _half_batch_left_out(monkeypatch):
    from repro_torch.models.transformer import TransformerLM

    orig = TransformerLM.decode_tokens_paged

    def half(self, *args, **kw):
        logits, pools = orig(self, *args, **kw)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return logits, pools

    monkeypatch.setattr(TransformerLM, "decode_tokens_paged", half)


def _token_altered(monkeypatch):
    from repro_torch.serving import sampling

    orig = sampling.sample_batched

    def altered(gen, logits, *args):
        return (orig(gen, logits, *args) + 1) % logits.shape[-1]

    monkeypatch.setattr(sampling, "sample_batched", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_left_out,
                                   _token_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("config", CONFIGS)
def test_fault_makes_the_run_incorrect(monkeypatch, fault, config):
    fault(monkeypatch)
    out = _run(config)
    assert not out.correct, out.checks
    assert any(c["value"] > c["limit"] for c in out.checks.values()
               if "limit" in c)
