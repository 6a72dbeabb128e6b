"""The port's §3 microbenchmark path on the CPU at tiny sizes: the H100
roofline model against the reference's formula, the STREAM, gather/scatter
and GEMM bench modules and the ``bench.run`` harness (``--device cpu``),
as ``tests/test_torch_bench.py`` runs the DLRM ones.  CPU rows carry host
times and no device rate."""
import json

import pytest
import torch

from benchmarks.common import tpu_time_model
from repro.roofline.analysis import HW as TpuHW
from repro_torch.bench import gather_scatter, gemm_roofline, run, stream
from repro_torch.roofline.analysis import H100, HW, bound_by, time_model


def test_h100_peaks_are_the_data_sheet():
    assert (H100.peak_bf16, H100.peak_f32, H100.hbm_bw, H100.hbm_bytes,
            H100.nvlink_bw) == (989e12, 67e12, 3.35e12, 80e9, 450e9)
    assert H100.peak(torch.bfloat16) == 989e12
    assert H100.peak(torch.float32) == 67e12
    with pytest.raises(ValueError):
        H100.peak(torch.int32)


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 1e10),
                                          (2 * 4096 ** 3, 6 * 4096 ** 2)])
def test_time_model_is_the_reference_formula(flops, nbytes):
    tpu = TpuHW()
    same = HW(peak_bf16=tpu.peak_bf16, hbm_bw=tpu.hbm_bw)
    assert time_model(flops, nbytes, torch.bfloat16, same) == \
        pytest.approx(tpu_time_model(flops, nbytes), rel=1e-12)
    t = time_model(flops, nbytes, torch.bfloat16)
    assert t == max(flops / 989e12, nbytes / 3.35e12)
    assert bound_by(flops, nbytes, torch.bfloat16) == (
        "bytes" if nbytes / 3.35e12 >= flops / 989e12 else "operations")


def test_stream_module_rows():
    rows = stream.run("cpu", quick=True, n=128 * 1024)
    names = [r["name"] for r in rows]
    assert names == ["stream_add_rows8", "stream_add_rows64",
                     "stream_add_rows256", "stream_add", "stream_scale",
                     "stream_triad", "stream_triad_oi1", "stream_triad_oi8",
                     "stream_triad_oi64", "stream_triad_oi512"]
    n = 128 * 1024
    for r in rows[:6]:
        assert r["ms"] > 0 and r["launches"] == 0 and r["calls"] == 7
        assert "device=cpu" in r["derived"] and "gbs=" not in r["derived"]
    assert [r["bytes"] for r in rows[3:6]] == [12 * n, 8 * n, 12 * n]
    assert [r["flops"] for r in rows[3:6]] == [n, n, 2 * n]
    # Fig 8 d-f: TRIAD reaches the float32 peak at 512 repeats
    assert rows[-1]["derived"].startswith("predicted;")
    assert "h100_util=1.000" in rows[-1]["derived"]
    assert "h100_util=0.008" in rows[-4]["derived"]


def test_gather_scatter_module_rows():
    rows = gather_scatter.run("cpu", R=64, N=32, vec_bytes=(16, 2048))
    assert [r["name"] for r in rows] == ["gather_16B", "scatter_16B",
                                         "gather_2048B", "scatter_2048B"]
    for r in rows:
        assert r["ms"] > 0 and r["library_ms"] > 0 and r["launches"] == 0
        assert "device=cpu" in r["derived"]
    g, s = rows[2], rows[3]
    assert g["bytes"] == g["distinct"] * 2048 + 32 * 2048 + 4 * 32
    assert s["bytes"] == 2 * s["distinct"] * 2048 + 4 * 32
    assert 0 < s["distinct"] <= 32
    assert "sector_eff=0.50" in rows[0]["derived"]


def test_gemm_module_rows():
    rows = gemm_roofline.run("cpu", shapes=[(64, 64, 64), (128, 128, 16)])
    assert [r["name"] for r in rows] == ["gemm_64x64x64", "gemm_128x128x16"]
    assert rows[0]["flops"] == 2 * 64 ** 3
    assert "bound=bytes" in rows[1]["derived"]
    assert "tflops=" not in rows[0]["derived"].replace("tflops_pred", "")
    shapes = gemm_roofline.shapes_for(quick=False)
    assert shapes[-3:] == [(8192, 8192, 8192), (2048, 2048, 16),
                           (4096, 4096, 16)]


def test_run_harness_writes_json(tmp_path, capsys):
    out = tmp_path / "rows.json"
    run.main(["--device", "cpu", "--only", "stream", "--json", str(out)])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "name,ms,derived"
    assert printed[1].startswith("stream_add_rows8,")
    results = json.loads(out.read_text())
    assert [r["module"] for r in results] == ["stream"]
    assert results[0]["device"] == "cpu" and len(results[0]["rows"]) == 10


def test_run_harness_takes_the_quick_dlrm_sweep(capsys):
    rows = run.runner("embedding_tables")("cpu", False)
    assert [r["name"] for r in rows[:2]] == ["embed_single_T4_B4_D64",
                                             "embed_batched_T4_B4_D64"]
    assert len(rows) == 8 and rows[-1]["name"] == "embed_batched_T20_B64_D64"


def test_run_harness_refuses_unknown_modules():
    with pytest.raises(SystemExit, match="collectives"):
        run.main(["--device", "cpu", "--only", "collectives"])


def test_microbench_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (run.main, stream.main, gather_scatter.main,
                 gemm_roofline.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
