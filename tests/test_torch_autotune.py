"""The port's kernel tunables and autotune table against the JAX package's.

``repro_torch.perf.autotune`` reads ``BENCH_010.json`` into the same best
configurations as ``repro.perf.autotune``, and a miss or an unreadable
file gives None.  With equivalent tables (the same cell under each
package's backend name) the engines resolve the same way, explicit >
table > defaults, with equal ``tune.*`` counters.  The CPU autotune sweep
marks exactly one best point a cell, with the defaults in its grid, and
its JSON reads back as a table.  The wrappers refuse tunables the kernels
cannot take, on the CPU too, and the port's defaults give the split and
the tile the kernels had before the keys existed, at every block size and
G."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_get_config
from repro.models.api import build_model as jax_build_model
from repro.perf import autotune as jautotune
from repro.serving import engine as jengine
from repro_torch.bench import paged_attention_bench as bench
from repro_torch.config import ServeConfig, get_config
from repro_torch.core import attention_api as api
from repro_torch.kernels.paged_attention.cases import (
    ARG_ORDER, CHUNKED_ARG_ORDER, DECODE_ARG_ORDER, SMALL, SMALL_CASES,
    decode_case, decode_lanes, ragged_case)
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.perf import autotune
from repro_torch.perf.table import SCHEMA_VERSION
from repro_torch.serving import engine as tengine

ROOT = Path(__file__).resolve().parents[1]
BENCH_010 = ROOT / "BENCH_010.json"
BS = 4


def test_table_from_bench_010_equals_the_reference():
    results = json.loads(BENCH_010.read_text())
    got = autotune.TuneTable.from_results(results).best
    want = jautotune.TuneTable.from_results(results).best
    assert got == want and len(got) >= 2
    assert autotune.TuneTable.load(str(BENCH_010)).best == want


def test_a_miss_or_an_unreadable_file_gives_none(tmp_path):
    assert autotune.resolve_tunables(16, 64, "cuda",
                                     path=str(BENCH_010)) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert autotune.resolve_tunables(8, 64, "ref", path=str(bad)) is None
    assert autotune.resolve_tunables(
        8, 64, "ref", path=str(tmp_path / "absent.json")) is None
    old = tmp_path / "old.json"
    old.write_text(json.dumps([{"module": "paged_attention_bench",
                                "schema_version": 0, "rows": []}]))
    assert autotune.resolve_tunables(8, 64, "ref", path=str(old)) is None
    # the reference's table holds this cell; the port never reads it by
    # default
    assert autotune.resolve_tunables(8, 64, "ref",
                                     path=str(BENCH_010)) is not None
    assert "BENCH_010" not in (autotune.default_tune_table_path() or "")


def test_the_environment_table_comes_first(tmp_path, monkeypatch):
    path = _table(tmp_path, [(4, 16, "plain", 21, 32)])
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", path)
    assert autotune.default_tune_table_path() == path
    assert autotune.resolve_tunables(4, 16, "plain") == dict(
        num_queries_per_block=21, num_kv_pages_per_block=32,
        vmem_limit_bytes=0)
    monkeypatch.delenv("REPRO_TORCH_TUNE_TABLE")
    assert autotune.default_tune_table_path() in (
        None, str(autotune.PACKAGED_TUNE_TABLE))


def _table(tmp_path, cells):
    """A benchmark JSON with one best=1 row per (page_size, head_dim,
    backend, rows, pages); returns its path."""
    rows = [{"name": f"t{i}", "ms": 1.0, "derived":
             f"tune=1;page_size={p};head_dim={h};backend={b};"
             f"num_queries_per_block={q};num_kv_pages_per_block={k};"
             "vmem_limit_bytes=0;best=1;vs_default=1.0"}
            for i, (p, h, b, q, k) in enumerate(cells)]
    path = tmp_path / "tune.json"
    path.write_text(json.dumps([{"module": "paged_attention_bench",
                                 "schema_version": SCHEMA_VERSION,
                                 "rows": rows}]))
    return str(path)


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


# (ServeConfig keywords, block size): all keys at 0 on the table's cell,
# one explicit, all explicit, the chunked kernel, a cell the table lacks
RESOLVE = [(dict(), BS), (dict(num_queries_per_block=7), BS),
           (dict(num_queries_per_block=5, num_kv_pages_per_block=64,
                 vmem_limit_bytes=4096), BS),
           (dict(attn_impl="chunked"), BS), (dict(), 8)]


@pytest.mark.parametrize("kw,block_size", RESOLVE,
                         ids=["table", "one-explicit", "all-explicit",
                              "chunked", "miss"])
def test_resolution_matches_the_reference_engine(models, tmp_path,
                                                 monkeypatch, kw,
                                                 block_size):
    (cfg_j, model_j, params_j), (cfg_t, model_t, params_t) = models
    hd = cfg_t.attention.head_dim
    # one cell under each package's backend name, the same values
    path = _table(tmp_path, [(BS, hd, "xla", 21, 16),
                             (BS, hd, "plain", 21, 16)])
    monkeypatch.setenv("REPRO_TUNE_TABLE", path)
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", path)
    ej = jengine.ServingEngine(
        model_j, params_j, cfg_j,
        JaxServeConfig(model=cfg_j.name, kv_block_size=block_size,
                       max_batch=2, **kw), num_blocks=16)
    et = tengine.ServingEngine(
        model_t, params_t, cfg_t,
        ServeConfig(model=cfg_t.name, kv_block_size=block_size, max_batch=2,
                    **kw), num_blocks=16, device="cpu")
    mj, mt = ej.metrics(), et.metrics()
    tune = [k for k in mj["policy_counters"] if k.startswith("tune.")]
    assert tune == ["tune.tuned_fallback", "tune.tuned_resolved"]
    assert ({k: mt["policy_counters"][k] for k in tune}
            == {k: mj["policy_counters"][k] for k in tune})
    defaults = api.TUNABLE_DEFAULTS
    for key in autotune.TUNABLE_KEYS:
        if kw.get(key, 0) > 0:                      # explicit wins
            assert mt[key] == mj[key] == kw[key]
        elif mj["policy_counters"]["tune.tuned_resolved"]:
            assert mt[key] == mj[key] == {"num_queries_per_block": 21,
                                          "num_kv_pages_per_block": 16,
                                          "vmem_limit_bytes": 0}[key]
        else:                                       # each package's default
            assert mt[key] == defaults[key]
    assert et.attn_tunables == {k: mt[k] for k in autotune.TUNABLE_KEYS}


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "llama31-8b"])
def test_a_table_row_means_one_tile_height_at_every_g(tmp_path, monkeypatch,
                                                      arch):
    """The table's key holds no G, so a row counts rows per tile, not
    lanes: reduced smollm-360m (G 3), granite-moe (G 2) and llama31-8b
    (G 4), all of head dim 16, resolve the same row to the same values."""
    cfg = get_config(arch).reduced(dtype="float32")
    a = cfg.attention
    assert a.head_dim == 16
    path = _table(tmp_path, [(BS, 16, "plain", 64, 32)])
    monkeypatch.setenv("REPRO_TORCH_TUNE_TABLE", path)
    et = tengine.ServingEngine(build_model(cfg, device="cpu"), None, cfg,
                               ServeConfig(model=cfg.name, kv_block_size=BS),
                               num_blocks=16, device="cpu")
    m = et.metrics()
    assert m["policy_counters"]["tune.tuned_resolved"] == 1
    assert (m["num_queries_per_block"], m["num_kv_pages_per_block"]) == (
        64, 32)
    assert api.check_tunables(BS, a.num_heads // a.num_kv_heads,
                              **et.attn_tunables) == et.attn_tunables


def test_the_cpu_sweep_marks_one_best_point_with_the_defaults_in_its_grid():
    dev = torch.device("cpu")
    rows = bench.autotune_sweep(dev, bench.tune_steps(dev), "cpu")
    assert rows and all("tune=1" in r["derived"] for r in rows)
    cells = {(r["page_size"], r["head_dim"], r["backend"]) for r in rows}
    assert cells == {(4, 16, "plain")}
    assert sum(r["best"] for r in rows) == 1
    assert sum(r["default"] for r in rows) == 1
    best = next(r for r in rows if r["best"])
    assert best["ms"] == min(r["ms"] for r in rows)
    assert len(rows) == len(bench.tune_grid(4)) == 8
    table = autotune.TuneTable.from_results(
        [{"module": "paged_attention_bench",
          "schema_version": SCHEMA_VERSION, "rows": rows}])
    assert table.lookup(4, 16, "plain") == {
        k: best[k] for k in autotune.TUNABLE_KEYS}


def test_the_sweep_takes_the_serving_phases_workload():
    """``phase5_prompts`` draws ``chip_smoke.py`` phase 5's prompts: the
    two warm-up prompts first, then 16 of 128-1024 tokens, every fourth one
    longer than 512 opening with the shared 256-token prefix."""
    prompts = bench.phase5_prompts(1000)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 1000, (256,), dtype=np.int32)
    assert len(prompts) == 16
    assert all(128 <= len(p) <= 1024 for p in prompts)
    assert all(np.array_equal(p[:256], shared) for i, p in
               enumerate(prompts) if i % 4 == 0 and len(p) > 512)


def test_defaults_give_the_kernels_earlier_split():
    """At every block size, those that divide no whole-page split of whole
    stages too, and every G, the defaults are the kernels' split of
    ``SPLIT_KEYS`` keys and ``128 // G`` lanes a tensor-core tile."""
    assert set(api.TUNABLE_DEFAULTS) == set(autotune.TUNABLE_KEYS)
    for bs in (1, 2, 3, 4, 5, 9, 12, 16, 18, 22, 48, 64, 512, 1024):
        for group in (1, 2, 3, 4, 7, 64):
            d = api.check_tunables(bs, group)
            assert d == api.TUNABLE_DEFAULTS
            assert api.split_keys_for(bs, d["num_kv_pages_per_block"]) \
                == api.SPLIT_KEYS
            assert d["num_queries_per_block"] // group == 128 // group


@pytest.mark.parametrize("block_size", [9, 18, 600])
def test_the_plain_versions_serve_any_block_size_at_the_defaults(
        block_size):
    """No whole-page split of whole stages fits these block sizes; the
    defaults split by keys, so the wrappers take them as before the keys
    existed."""
    c = ragged_case(np.random.default_rng(0),
                    **dict(SMALL, block_size=block_size),
                    **SMALL_CASES["mixed"])
    args = [torch.from_numpy(c[k]) for k in ARG_ORDER]
    assert torch.equal(api.paged_attention_ragged_op(*args),
                       api.paged_attention_ragged(*args))
    with pytest.raises(ValueError, match="num_kv_pages_per_block"):
        api.paged_attention_ragged_op(*args, num_kv_pages_per_block=1)


BAD = [dict(num_kv_pages_per_block=3),                   # 12 keys
       dict(num_kv_pages_per_block=129),                 # 516 keys
       dict(num_kv_pages_per_block=-16),
       dict(num_queries_per_block=0),
       dict(num_queries_per_block=129),                  # > 128 rows
       dict(num_queries_per_block=2),                    # < G = 3
       dict(vmem_limit_bytes=-1)]


@pytest.mark.parametrize("kw", BAD, ids=["partial-stage", "over-512",
                                         "negative-pages", "no-row",
                                         "over-128-rows", "under-g",
                                         "negative-cap"])
def test_the_wrappers_refuse_bad_tunables(kw):
    c = ragged_case(np.random.default_rng(0),
                    **dict(SMALL, **SMALL_CASES["mixed"]))
    args = [torch.from_numpy(c[k]) for k in ARG_ORDER]
    with pytest.raises(ValueError):
        api.paged_attention_ragged_op(*args, **kw)
    if "num_queries_per_block" in kw:
        return                        # the ragged kernel's key alone
    d = decode_case(np.random.default_rng(1), **SMALL, seq_lens=[9, 4, 13],
                    num_entries=12)
    lanes = decode_lanes(d)
    with pytest.raises(ValueError):
        api.paged_attention_op(*[torch.from_numpy(d[k])
                                 for k in DECODE_ARG_ORDER], **kw)
    pool = torch.from_numpy(lanes["kv_pool"])
    with pytest.raises(ValueError):
        api.paged_attention_chunked_op(
            torch.from_numpy(lanes["q"]), pool[:, :, 0::2], pool[:, :, 1::2],
            *[torch.from_numpy(lanes[k]) for k in CHUNKED_ARG_ORDER], **kw)


def test_the_plain_versions_ignore_good_tunables():
    c = ragged_case(np.random.default_rng(0),
                    **dict(SMALL, **SMALL_CASES["mixed"]))
    args = [torch.from_numpy(c[k]) for k in ARG_ORDER]
    want = api.paged_attention_ragged(*args)
    for rows, pages in ((21, 16), (128, 128), (10, 32), (64, 0)):
        got = api.paged_attention_ragged_op(
            *args, num_queries_per_block=rows, num_kv_pages_per_block=pages,
            vmem_limit_bytes=65536)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="vmem_limit_bytes"):
        tengine.ServingEngine(
            build_model(get_config("smollm-360m").reduced(dtype="float32"),
                        device="cpu"), None,
            get_config("smollm-360m").reduced(dtype="float32"),
            ServeConfig(model="smollm-360m", kv_block_size=4,
                        vmem_limit_bytes=-8), num_blocks=8, device="cpu")


def test_split_capacity_bounds_every_split_size():
    d = decode_case(np.random.default_rng(2), **dict(SMALL, num_blocks=200),
                    seq_lens=[1, 16, 17, 130, 600, 0], num_entries=220,
                    shuffle=True)
    BS = d["pool_k"].shape[1]
    for split in (64, 128, 256, 512):
        pages = [int(((d["block_req"] == b)
                      & (d["block_pos"].astype(np.int64) * BS < n)).sum())
                 for b, n in enumerate(d["seq_lens"])]
        need = sum(max(1, -(-p * BS // split)) for p in pages)
        assert need <= api.split_capacity(len(pages), len(d["block_list"]),
                                          BS, split)


def test_the_packaged_table_holds_the_card_cells_with_their_defaults():
    """The committed ``tune_h100.json`` (written by ``bench.run --only
    paged_attention_bench --json`` on the card) parses, names the card,
    holds (16, 64, cuda) and (16, 128, cuda) with the defaults in each
    grid, and its winners are tunables the kernels take there."""
    path = autotune.PACKAGED_TUNE_TABLE
    results = json.loads(path.read_text())
    assert [r["schema_version"] for r in results] == [SCHEMA_VERSION]
    assert "H100" in results[0]["card"]
    table = autotune.TuneTable.load(str(path))
    assert set(table.best) == {(16, 64, "cuda"), (16, 128, "cuda")}
    for (bs, hd, backend), best in table.best.items():
        for group in (2, 3, 4):     # granite-moe, smollm-360m, llama31-8b
            api.check_tunables(bs, group, **best)
        rows = [r for r in results[0]["rows"]
                if f"page_size={bs};head_dim={hd};backend={backend}"
                in r["derived"]]
        points = {(int(d["num_queries_per_block"]),
                   int(d["num_kv_pages_per_block"]))
                  for d in map(lambda r: dict(
                      f.split("=", 1) for f in r["derived"].split(";")),
                      rows)}
        assert points == set(bench.tune_grid(bs))
        default = api.TUNABLE_DEFAULTS
        assert (default["num_queries_per_block"],
                default["num_kv_pages_per_block"]) in points
        assert sum("best=1" in r["derived"] for r in rows) == 1
