import pytest

from perfbench.counts import b1, flops, moe, peaks
from perfbench.harness import model, spec

GRANITE = model.dims(spec.load_json(spec.PACKAGE / "configs" /
                                    "granite_moe.json"))
SMOLLM = model.dims(spec.load_json(spec.PACKAGE / "configs" / "smollm.json"))


def test_layer_params_by_hand():
    # granite: q, k, v, o = 1024 x (1024 + 512 + 512 + 1024); router
    # 1024 x 32; 8 routed experts of 3 x 1024 x 512
    assert flops.layer_params(GRANITE) == (3_145_728 + 32_768
                                           + 12_582_912)
    # smollm: 960 x (960 + 320 + 320 + 960) + 3 x 960 x 2560
    assert flops.layer_params(SMOLLM) == 2_457_600 + 7_372_800


def test_param_count_matches_the_published_size():
    # the port's num_params, and the final norm it leaves out
    assert model.num_params(GRANITE) == 1_334_627_328 + 1024
    assert model.num_params(SMOLLM) == 361_820_160 + 960


def test_causal_keys_by_hand():
    assert flops.causal_keys(1, 10) == 10            # a decode lane
    assert flops.causal_keys(4, 4) == 1 + 2 + 3 + 4  # a whole prompt
    assert flops.causal_keys(3, 7) == 5 + 6 + 7      # a later chunk


@pytest.mark.parametrize("arch,d", [("granite-moe-1b-a400m", GRANITE),
                                    ("smollm-360m", SMOLLM)])
def test_against_the_ports_model_flops(arch, d):
    from repro_torch.config import ShapeCell, get_config
    from repro_torch.roofline.model_flops import model_flops

    cfg = get_config(arch)
    S = 2048
    want = model_flops(cfg, ShapeCell("p", S, 1, "prefill"))
    # model_flops: 2 x active params (embedding and norms included, so the
    # head counts on every token) and attention at S / 2 keys a token;
    # counts: the head only on the rows that sample, exact causal keys
    norms = 2 * d.layers * 2 * d.d_model
    exact = flops.step_flops(d, [(S, S)], sampled_rows=S)
    half_key = 2 * d.heads * d.head_dim * d.layers * S
    assert exact + S * norms - half_key == want
    decode = model_flops(cfg, ShapeCell("d", S, 8, "decode"))
    assert flops.step_flops(d, [(1, S)] * 8, 8) + 8 * norms == decode


def test_b1_counts_by_hand():
    # one decode lane over 200 keys and a 3-lane chunk ending at 130 keys,
    # 128-key pages, granite: 8 kv heads, 16 heads, hd 64, bf16
    ops, nbytes = b1.call_counts(GRANITE, [(1, 200), (3, 130)], 128)
    assert ops == 4 * 64 * 16 * (200 + 128 + 129 + 130)
    assert nbytes == ((200 + 130) * 2 * 8 * 64 * 2 + 2 * 4 * 16 * 64 * 2
                      + 4 * (3 * (2 + 2) + 3 * 2 + 2))
    t, by = b1.step_bound_s(GRANITE, [(1, 200), (3, 130)], 128)
    assert by == "bytes"
    assert t == pytest.approx(24 * nbytes / peaks.HBM_BYTES_PER_S)


def test_moe_counts_by_hand():
    ops, nbytes = moe.layer_counts(GRANITE, 1000)
    assert ops == 1000 * (2 * 1024 * 32 + 8 * 6 * 1024 * 512)
    assert nbytes == 32 * 3 * 1024 * 512 * 2 + 1024 * 32 * 4 + 2 * 1000 * 2048
    t, by = moe.step_bound_s(GRANITE, 8000)
    assert by == "flops"
    assert t == pytest.approx(24 * moe.layer_counts(GRANITE, 8000)[0]
                              / peaks.BF16_FLOPS)


# a window of mixed steps: prefill chunks beside decode lanes, a step of
# decode lanes alone, a step of one whole prompt
STEPS = [([(2048, 2048), (1, 300), (1, 4000)], 2),
         ([(1, 129 + k) for k in range(64)], 64),
         ([(960, 3000), (1, 1024)], 1)]
BENCH = spec.Benchmark()
CELLS = sorted(BENCH.cells)


def _mixed_window(d, counts=None):
    from perfbench.harness import trace
    from perfbench.systems import serve

    steps = [serve.Step(end=float(k), lanes=lanes, sampled=sampled)
             for k, (lanes, sampled) in enumerate(STEPS)]
    summary = trace.TraceSummary(
        busy_s=2.0, device_s_by_kernel={"ragged_attention_kernel<64>": 0.03,
                                        "entry_lists_kernel": 0.002,
                                        "gemm": 1.0},
        span_device_s={"moe": 0.4})
    kw = {} if counts is None else {"counts": counts}
    return serve.Window(t0=0.0, t1=2.5, setup_s=1.0, dims=d, block_size=128,
                        records=[], steps=steps, phase_s={}, trace=summary,
                        **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_readings_through_the_window_equal_the_formulas(cell):
    config = BENCH.config(BENCH.cell(cell))
    d = model.dims(config)
    for w in (_mixed_window(d), _mixed_window(d, spec.counts_module(config))):
        got = {n: BENCH.reader({"name": n}).read(w)
               for n in ("mfu", "b1_roofline", "moe_roofline")}
        total = sum(flops.step_flops(d, s.lanes, s.sampled) for s in w.steps)
        assert got["mfu"] == 100.0 * total / (2.5 * peaks.BF16_FLOPS)
        bound = 0.0
        for s in w.steps:
            bound += b1.step_bound_s(d, s.lanes, 128)[0]
        assert got["b1_roofline"] == 100.0 * bound / (0.03 + 0.002)
        if not d.moe:
            assert got["moe_roofline"] is None
            continue
        bound = 0.0
        for s in w.steps:
            bound += moe.step_bound_s(d, sum(n for n, _ in s.lanes))[0]
        assert got["moe_roofline"] == 100.0 * bound / 0.4


@pytest.mark.parametrize("cell", CELLS)
def test_a_config_without_the_keys_takes_the_default_model_and_counts(cell):
    from perfbench.counts import transformer
    from perfbench.systems import serve

    config = BENCH.config(BENCH.cell(cell))
    assert not {"model", "counts"} & set(config)
    assert spec.model_module(config) is model
    counts = spec.counts_module(config)
    assert counts is transformer
    assert (counts.step_flops, counts.b1_step_bound_s,
            counts.moe_step_bound_s) == (flops.step_flops, b1.step_bound_s,
                                         moe.step_bound_s)
    assert _mixed_window(None).counts is transformer
    assert serve.port_config is model.port_config
