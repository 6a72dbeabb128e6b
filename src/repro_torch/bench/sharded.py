"""The sharded serving path's checks, as jobs a rank runs: the reference's
acceptance sweep of the mesh-native engine (``tests/test_sharded_engine.py``
``_SWEEP`` and its copy-on-write case) and the sharded attention and
embedding ops on one input.

Each ``*_job`` is a module-level function for
:func:`repro_torch.launch.mesh.run_ranks` (every rank runs it and returns
its result) or for one process without a mesh.  The tests run them on the
CPU over gloo ranks and hold them to the single-device engine and to the
JAX package; ``chip_smoke.py`` runs them on the card.

    from repro_torch.bench import sharded
    from repro_torch.launch.mesh import run_ranks
    single = sharded.sweep_job(False, "cpu")
    ranks = run_ranks(sharded.sweep_job, 2, (True, "cpu"))
    assert all(r["runs"] == single["runs"] for r in ranks)
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

# The reference's sweep: two triples x proposers off / ngram x a roomy and
# a tight pool, over four requests of which two loop a 3-token motif.
TRIPLES = (("fcfs", "latest-arrival", "lru"),
           ("priority", "fewest-remaining-tokens", "hit-rate"))
SPECS = ("off", "ngram")
NUM_BLOCKS = (64, 16)
ARCH = "smollm-360m"
COW_CROSS_STEPS = 5


def sweep_requests(vocab: int) -> List[Dict]:
    """The sweep's four requests (the reference's, from
    ``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(4):
        if i % 2:                       # looping motif: ngram drafts land
            prompt = np.tile(rng.integers(0, vocab, (3,), dtype=np.int32), 3)
        else:
            prompt = rng.integers(0, vocab, (int(rng.integers(4, 12)),),
                                  dtype=np.int32)
        reqs.append(dict(req_id=i, prompt=prompt, max_new_tokens=8,
                         priority=i % 2))
    return reqs


def cases():
    """(spec, triple, num_blocks) of the sweep, in the reference's order."""
    return [(spec, triple, nb) for spec in SPECS for triple in TRIPLES
            for nb in NUM_BLOCKS]


def reduced_model(device, weights: Optional[str] = "reference"):
    """(cfg, model, params): reduced float32 smollm-360m with the
    reference's ``init(PRNGKey(0))`` weights (``"reference"``, the npz of
    ``bench.trace_replay``) or the port's seeded draw (None)."""
    from repro_torch.bench.trace_replay import REFERENCE_WEIGHTS, load_weights
    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    cfg = get_config(ARCH).reduced(dtype="float32")
    model = build_model(cfg, device=device)
    params = (load_weights(REFERENCE_WEIGHTS, device) if weights
              else model.init(0))
    return cfg, model, params


def _mesh(on: bool):
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh() if on else None


def _summary(eng) -> Dict:
    m = eng.metrics()
    return dict(outputs={r.req_id: [int(t) for t in r.output]
                         for r in eng.finished},
                metrics=m, cow_moves=getattr(eng, "cow_moves", 0))


def run_case(model, params, cfg, spec, triple, num_blocks, mesh, device,
             attn_impl="ragged") -> Dict:
    """One sweep case through a fresh engine: outputs and metrics."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving.engine import Request, ServingEngine

    adm, pre, evi = triple
    serve = ServeConfig(model=cfg.name, kv_block_size=4, max_batch=3,
                        admission=adm, preemption=pre, eviction=evi,
                        spec=spec, spec_k=3, attn_impl=attn_impl)
    eng = ServingEngine(model, params, cfg, serve, num_blocks=num_blocks,
                        mesh=mesh, device=device)
    for r in sweep_requests(cfg.vocab_size):
        eng.submit(Request(**r))
    eng.run_until_done()
    eng.alloc.check_invariants(drained=True)
    return _summary(eng)


def cow_case(model, params, cfg, mesh, device, steps: int = 3) -> Dict:
    """The reference's copy-on-write case: a borrower adopts a live
    donor's three full prefix blocks and copies one on its first append."""
    from repro_torch.config import ServeConfig
    from repro_torch.serving.engine import Request, ServingEngine

    serve = ServeConfig(model=cfg.name, kv_block_size=4, max_batch=2)
    prefix = np.random.default_rng(0).integers(0, cfg.vocab_size, (12,),
                                               dtype=np.int32)
    eng = ServingEngine(model, params, cfg, serve, num_blocks=64, mesh=mesh,
                        device=device)
    eng.submit(Request(req_id=0, prompt=prefix.copy(), max_new_tokens=8))
    for _ in range(steps):      # donor's hashes publish; donor keeps decoding
        eng.step()
    eng.submit(Request(req_id=1, prompt=prefix.copy(), max_new_tokens=6))
    eng.run_until_done()
    eng.alloc.check_invariants(drained=True)
    return _summary(eng)


def sweep_job(mesh_on: bool, device: str = "cpu",
              weights: Optional[str] = "reference",
              attn_impls=("ragged",), with_cow: bool = True) -> Dict:
    """The whole sweep (and the copy-on-write case, as the reference runs
    it and with the copy across ranks) on this process's mesh
    (``mesh_on``) or on one device: ``{"runs": [...], "cow": ...,
    "cow_cross": ...}``, one run per (attn_impl, case), each ``{"case",
    "outputs", "metrics", "cow_moves"}``."""
    cfg, model, params = reduced_model(device, weights)
    mesh = _mesh(mesh_on)
    runs = []
    for impl in attn_impls:
        for spec, triple, nb in cases():
            r = run_case(model, params, cfg, spec, triple, nb, mesh, device,
                         attn_impl=impl)
            r["case"] = (impl, spec, "/".join(triple), nb)
            runs.append(r)
    out = {"runs": runs}
    if with_cow:
        out["cow"] = cow_case(model, params, cfg, mesh, device)
        # two more donor steps: on two ranks the copy's source and
        # destination then lie on different ranks (on four, at three too)
        out["cow_cross"] = cow_case(model, params, cfg, mesh, device,
                                    steps=COW_CROSS_STEPS)
    return out


# a reduced llama31-8b whose every attention projection, wo, the MLP, the
# embedding and the (untied) head split over 2 ranks: 4 q heads over 2 kv
# heads
TP_ARCH = "llama31-8b"
TP_HEADS = dict(num_heads=4, num_kv_heads=2)


def tp_job(mesh_on: bool, device: str = "cpu") -> Dict:
    """Two sweep cases (``off`` and ``ngram``, fcfs, the roomy pool) on
    :data:`TP_ARCH` reduced with :data:`TP_HEADS` and seeded weights, on
    this process's mesh or one device: ``{"runs": [...], "split": [...]}``
    with the leaves the rules split."""
    import dataclasses

    from repro_torch.config import get_config
    from repro_torch.models.api import build_model

    cfg = get_config(TP_ARCH).reduced(dtype="float32")
    cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, **TP_HEADS))
    model = build_model(cfg, device=device)
    params = model.init(0)
    mesh = _mesh(mesh_on)
    runs = [run_case(model, params, cfg, spec, TRIPLES[0], NUM_BLOCKS[0],
                     mesh, device) for spec in SPECS]
    split = []
    if mesh is not None:
        tp = model.tensor_parallel(mesh)
        split = [n for n in ("wq", "wk", "wv", "wo")
                 if tp.split("layers", "attn", n)]
        split += ["w_gate"] * tp.split("layers", "mlp", "w_gate")
        split += ["embed"] * tp.split("embed", "table")
        split += ["head"] * tp.split("head", "table")
    return {"runs": runs, "split": split}


def shard_pool(pool: torch.Tensor, mesh, axis: str = "model"):
    """This rank's contiguous block of a (…, NB, …) pool's block dim (dim
    0 of one layer's pool)."""
    S, r = mesh.size(axis), mesh.axis_index(axis)
    per = pool.shape[0] // S
    return pool[r * per:(r + 1) * per].contiguous()


def attention_job(inputs: Dict, device: str = "cpu") -> Dict:
    """The three sharded attention ops on this rank's shard of one input
    (numpy arrays of a whole pool and its flat BlockList, as
    ``tests/test_torch_sharded_attention.py`` builds them), and the
    row-sharded lookup: each rank cuts its pool block and local lists with
    the allocator's render, runs the op and returns the combined output
    (numpy) beside the launches of the kernels it ran."""
    from repro_torch.core import attention_api as api
    from repro_torch.core import embedding_api as emb
    from repro_torch.core import paged_kv
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh()
    S, r = mesh.size("model"), mesh.axis_index("model")
    dev = torch.device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    nb = inputs["kv_pool"].shape[0]
    per = nb // S
    pages = inputs["owner_pages"]          # [(owner, [blocks...]), ...]
    bl, br, bp = paged_kv.shard_block_lists(pages, S, per,
                                            pad_req=inputs["pad_req"])
    local = dict(block_list=t(bl[r]), block_req=t(br[r]),
                 block_pos=t(bp[r]))
    kv_pool = t(inputs["kv_pool"])
    pool_r = shard_pool(kv_pool, mesh)
    q = t(inputs["q"])
    out = {}
    out["ragged"] = api.paged_attention_ragged_sharded(
        q, pool_r, local["block_list"], local["block_req"],
        local["block_pos"], t(inputs["cu_q_lens"]), t(inputs["cu_kv_lens"]),
        t(inputs["seq_slot"]), mesh=mesh)
    pk, pv = paged_kv.fused_kv_views(pool_r)
    out["chunked"] = api.paged_attention_chunked_sharded(
        q, pk, pv, local["block_list"], local["block_req"],
        local["block_pos"], t(inputs["kv_lens"]), t(inputs["token_req"]),
        t(inputs["token_pos"]), mesh=mesh)
    dq = t(inputs["decode_q"])
    dpages = inputs["decode_pages"]
    dbl, dbr, dbp = paged_kv.shard_block_lists(dpages, S, per,
                                               pad_req=dq.shape[0])
    out["decode"] = api.paged_attention_sharded(
        dq, pk.contiguous(), pv.contiguous(), t(dbl[r]), t(dbr[r]),
        t(dbp[r]), t(inputs["seq_lens"]), mesh=mesh)
    table = t(inputs["table"])
    rows = table.shape[0] // S
    out["lookup"] = emb.batched_table_lookup_sharded(
        table[r * rows:(r + 1) * rows].contiguous(), t(inputs["offsets"]),
        t(inputs["indices"]), mesh=mesh)
    return {k: v.cpu().numpy() for k, v in out.items()}
