"""Serving: the port's ``ServingEngine`` under a closed loop of clients.

The configuration's model module (``spec.model_module``) gives the sizes,
the weights and the port's model; its counts module (``spec.
counts_module``) goes to the readers in the window.  Set-up builds the
kernels the engine loads (a cache hit in ``build/kernels`` after a
checkout's first run), draws the weights from the seed, builds the model
and the engine with the configuration's knobs and KV pool, and ramps:
every client sends at once and the loop runs until each client's first
request has completed, so every slot has turned over once, and until the
pool's free blocks are spent and the allocator evicts cached blocks, the
state a long-running server is in (prompts are distinct, so every full
block a request leaves stays cached until evicted).  The window
then runs ``engine.step()`` until ``seconds`` have passed.  After each
step returns (greedy, overlap off, so the step's tokens are resolved) the
harness stamps, on its own clock, each request's first token and its
completion, the lanes each request ran (its KV length before and after,
less what the prefix cache served) and the rows that sampled a token.  A
completed request's client sends its next request at once.

``correct``: once the window has closed, the peak memory has been read and
the engine is gone, a sample of the requests completed in the window
(drawn from the seed, the one with most output tokens in it) is run
through the configuration's float32 reference over prompt and served
tokens, on the model module's second draw of the weights.  Each served
token's gap is how far its logit lies below the reference's best at its
position; the widest gap and the mean gap are held to the limits the
configuration states for them.
"""
from __future__ import annotations

import contextlib
import gc
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.counts import transformer as transformer_counts
from perfbench.harness import spec
from perfbench.harness import trace as trace_lib
from perfbench.harness.model import port_config  # noqa: F401 (its old home)

clock = time.perf_counter
RAMP_LIMIT_S = 600.0


@dataclass
class Record:
    req: object
    client: int
    sent: float
    first: Optional[float] = None
    done: Optional[float] = None
    emitted: int = 0


@dataclass
class Step:
    end: float
    lanes: List[Tuple[int, int]]        # (new lanes, keys after) a request
    sampled: int                        # rows that sampled a token


@dataclass
class Window:
    """What the metric readers read."""
    t0: float
    t1: float
    setup_s: float
    dims: object                        # the model module's sizes
    block_size: int
    records: List[Record]
    steps: List[Step]
    phase_s: Dict[str, float]
    trace: Optional[trace_lib.TraceSummary] = None
    notes: Dict[str, object] = field(default_factory=dict)
    counts: ModuleType = transformer_counts

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def inside(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t <= self.t1


@dataclass
class Outcome:
    window: Window
    correct: bool
    attempted: int
    failed: int
    checks: Dict[str, dict]
    memory_peak_bytes: int
    readings: Dict[str, float] = field(default_factory=dict)


def _kv_len(req) -> int:
    """Tokens of ``req`` whose K/V the pool holds after a resolved step."""
    st = req.state.name
    if st == "PREFILLING":
        return req.prefill_pos
    if st in ("DECODING", "FINISHED"):
        return len(req.prompt) + len(req.output) - 1
    return 0


class ClosedLoop:
    """The clients, the engine and the stamps of every step."""

    def __init__(self, engine, requests, clients: int, request_cls):
        self.engine = engine
        self.requests = requests
        self.request_cls = request_cls
        self.records: List[Record] = []
        self.live: Dict[int, Record] = {}
        self.steps: List[Step] = []
        now = clock()
        for c in range(clients):
            self.send(c, now)

    def send(self, client: int, now: float) -> None:
        prompt, n_out = self.requests.next()
        req = self.request_cls(req_id=len(self.records), prompt=prompt,
                               max_new_tokens=n_out, arrival=time.time())
        rec = Record(req=req, client=client, sent=now)
        self.records.append(rec)
        self.live[req.req_id] = rec
        self.engine.submit(req)

    def step(self) -> None:
        before = {rid: _kv_len(r.req) for rid, r in self.live.items()}
        self.engine.step()
        now = clock()
        lanes, sampled, done = [], 0, []
        for rid, rec in self.live.items():
            req = rec.req
            k0, k1 = before.get(rid, 0), _kv_len(req)
            new = k1 - k0
            if k0 == 0 and new > 0:
                new -= req.cached_prompt_tokens
            if new > 0:
                lanes.append((new, k1))
            n = len(req.output)
            if n > rec.emitted:
                sampled += n - rec.emitted
                rec.emitted = n
                if rec.first is None:
                    rec.first = now
            if req.state.name == "FINISHED":
                rec.done = now
                done.append(rid)
        for rid in done:
            rec = self.live.pop(rid)
            self.send(rec.client, now)
        self.steps.append(Step(now, lanes, sampled))


def _sample(records: List[Record], seed: int, tokens: int) -> List[Record]:
    """Requests to compare: the one with most output tokens, then others
    in an order drawn from the seed, until ``tokens`` served tokens."""
    if not records:
        return []
    longest = max(records, key=lambda r: (r.emitted, len(r.req.prompt)))
    rest = [r for r in records if r is not longest]
    order = np.random.default_rng((seed % (1 << 64), 17)).permutation(
        len(rest))
    out, n = [longest], longest.emitted
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += rest[i].emitted
    return out


def gaps(reference, weights, d, sample: List[Record], device, *,
         control: bool = False):
    """Each served token's gap below the reference's best at its position
    (float32 numpy), and with ``control`` the gap of the fp8 reference's
    own first choice at the same positions (else None)."""
    got, ctl_got = [], []
    for rec in sample:
        req = rec.req
        prompt = np.asarray(req.prompt, np.int64)
        served = np.asarray(req.output, np.int64)
        seq = torch.from_numpy(np.concatenate([prompt, served[:-1]])).to(
            device)
        rows = torch.arange(len(prompt) - 1, len(seq), device=device)
        ref = reference.logits(weights, d, seq, rows)
        best = ref.max(dim=-1).values
        tok = torch.from_numpy(served).to(device)
        got.append((best - ref.gather(1, tok[:, None])[:, 0]).cpu())
        if control:
            pick = reference.logits(weights, d, seq, rows,
                                    fp8=True).argmax(dim=-1)
            ctl_got.append((best - ref.gather(1, pick[:, None])[:, 0]).cpu())
        del ref
    empty = [torch.zeros((0,))]
    return (torch.cat(got or empty).numpy(),
            torch.cat(ctl_got or empty).numpy() if control else None)


def numbers(g: np.ndarray) -> Dict[str, float]:
    """The numbers compared: the widest and the mean gap."""
    if not len(g):
        return {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def run(config: dict, traffic: dict, generator, *, seed: int,
        seconds: float, trace: bool, device: str, t_start: float,
        log: Callable[[str], None], control: bool = False) -> Outcome:
    from repro_torch.serving import sampling as sampling_lib
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.config import ServeConfig

    models, counts = spec.model_module(config), spec.counts_module(config)
    dev = torch.device(device)
    d = models.dims(config)
    if dev.type == "cuda":
        from repro_torch.kernels import build as kbuild

        for name, info in kbuild.build_all(config["kernels"]).items():
            log(f"kernel build {name}: cache_hit={info['cache_hit']} "
                f"seconds={info['seconds']:.3f}")
    t = clock()
    params = models.draw(d, seed, dev)
    cfg, model = models.build(config, d, dev)
    serve = ServeConfig(model=cfg.name, **config["serve"])
    engine = ServingEngine(model, params, cfg, serve,
                           num_blocks=config["kv_pool"]["blocks"],
                           seed=seed % (1 << 63), device=dev)
    _sync(dev)
    log(f"weights and engine: {clock() - t:.3f} s, "
        f"{models.num_params(d)} parameters, "
        f"{config['kv_pool']['blocks']} KV blocks")
    summary = trace_lib.TraceSummary() if trace else None
    spans = trace_lib.Spans()
    if trace:
        spans.wrap(models.moe_module(), "moe_apply", "moe")
        spans.wrap(engine.scheduler, "schedule", "schedule")
        spans.wrap(engine, "_render", "render")
        spans.wrap(engine, "_forward", "forward")
        spans.wrap(engine, "_resolve", "resolve")
        spans.wrap(sampling_lib, "sample_batched", "sample")
    try:
        loop = ClosedLoop(engine, generator.make(traffic, seed, d.vocab),
                          int(traffic["clients"]), Request)
        first = loop.records[:int(traffic["clients"])]
        t = clock()
        while (any(r.done is None for r in first)
               or engine.alloc.cache_evictions == 0):
            loop.step()
            if clock() - t > RAMP_LIMIT_S:
                raise RuntimeError("the ramp did not reach steady state")
        log(f"ramp: {clock() - t:.3f} s, {len(loop.steps)} steps, "
            f"{sum(r.done is not None for r in loop.records)} completed")
        _sync(dev)
        phase0 = dict(engine.metrics()["phase_s"])
        n0 = len(loop.steps)
        with (trace_lib.profiled(summary) if trace
              else contextlib.nullcontext()):
            t0 = clock()
            while clock() - t0 < seconds:
                loop.step()
            _sync(dev)
            t1 = clock()
    finally:
        spans.close()
    m = engine.metrics()
    phase = {k: m["phase_s"].get(k, 0.0) - phase0.get(k, 0.0)
             for k in m["phase_s"]}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    log(f"preemptions: {m['preemptions']}, steps in the window: "
        f"{len(loop.steps) - n0}")
    if summary is not None:
        log(f"trace: {summary.kinds}, reduced in {summary.seconds:.1f} s")
    window = Window(t0=t0, t1=t1, setup_s=t0 - t_start, dims=d,
                    block_size=serve.kv_block_size, records=loop.records,
                    steps=loop.steps[n0:], phase_s=phase, trace=summary,
                    counts=counts)
    live = [r for r in loop.records if r.sent <= t1
            and (r.done is None or r.done >= t0)]
    finished = [r for r in loop.records if window.inside(r.done)]
    failed = sum(len(r.req.output) != r.req.max_new_tokens for r in finished)
    limits = config["correct"]
    sample = _sample(finished, seed, int(limits["sample_tokens"]))
    del engine, loop.engine, params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = clock()
    reference = spec.load_module(spec.PACKAGE / config["reference"],
                                 "reference")
    reference.no_tf32()
    weights = models.draw(d, seed, dev)
    got, ctl = gaps(reference, weights, d, sample, dev, control=control)
    del weights
    log(f"reference: {len(sample)} requests, {len(got)} served tokens, "
        f"{clock() - t:.3f} s")
    readings = {f"program.{k}": v for k, v in numbers(got).items()}
    if ctl is not None:
        readings.update({f"control.{k}": v for k, v in numbers(ctl).items()})
    log(f"readings: {readings}")
    checks = {k: {"value": readings[f"program.{k}"], "limit": limit}
              for k, limit in limits["logit_gap_limits"].items()}
    checks["tokens_compared"] = {"value": len(got),
                                 "at_least": limits["min_tokens"]}
    ok = (all(c["value"] <= c["limit"] for k, c in checks.items()
              if k != "tokens_compared")
          and len(got) >= limits["min_tokens"])
    return Outcome(window=window, correct=bool(ok and failed == 0),
                   attempted=len(live), failed=failed, checks=checks,
                   memory_peak_bytes=int(peak), readings=readings)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

