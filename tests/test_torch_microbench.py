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
from repro_torch.bench.common import rates
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


@pytest.mark.parametrize("n,in_l2", [(2 ** 21, True), (2 ** 28, False)])
def test_stream_rows_in_the_l2_claim_no_share_of_hbm(n, in_l2):
    """Fig 8's ADD moves 24 MiB at the reference's 2^21 float32 elements,
    inside the 50 MB L2, and 3 GiB at 2^28, over four times it: only the
    second may print a share of the HBM's rate."""
    nbytes = 3 * 4 * n
    assert nbytes == (24 * 2 ** 20 if in_l2 else 3 * 2 ** 30)
    assert H100.fits_in_l2(nbytes) is in_l2
    assert H100.fits_in_l2(2 * 4 * n) is in_l2           # SCALE
    assert in_l2 or nbytes >= 4 * H100.l2_bytes
    share = rates(0.5, n, nbytes, H100.fits_in_l2(nbytes))
    assert ("in_l2" in share) is in_l2
    assert ("hbm_share=" in share) is not in_l2
    assert H100.fits_in_l2(H100.l2_bytes)
    assert not H100.fits_in_l2(H100.l2_bytes + 1)


def test_stream_quick_rows_carry_in_l2():
    rows = stream.run("cpu", quick=True)
    timed = [r for r in rows if "op" in r]
    assert len(timed) == 6
    for r in timed:
        assert r["in_l2"] is H100.fits_in_l2(r["bytes"]) is True
        assert "hbm_share" not in r["derived"]


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


def test_gather_scatter_sector_bytes_and_yardstick():
    """The sector bound counts each 32-byte sector a row touches once, and
    a read of each sector the scatter writes only in part; the scatter
    row names its yardstick."""
    R, N = 64, 32
    rows = gather_scatter.run("cpu", R=R, N=N, vec_bytes=(16, 64))
    gen = torch.Generator()
    gen.manual_seed(0)
    for vb, (g, s) in zip((16, 64), (rows[:2], rows[2:])):
        torch.randn((R, vb // 4), generator=gen)      # the table, the src
        torch.randn((N, vb // 4), generator=gen)
        idx = torch.randint(0, R, (N,), generator=gen).tolist()
        per = vb // 16                 # 16-byte halves of sectors a row
        last = {r: n for n, r in enumerate(idx)}
        halves = {r * per + k for r in set(idx) for k in range(per)}
        read = {(n * per + k) // 2 for n in last.values()
                for k in range(per)}
        ids_out = -(-4 * N // 32)
        assert g["sector_bytes"] == 32 * (len({h // 2 for h in halves})
                                          + -(-N * vb // 32) + ids_out)
        partial = sum(1 for sec in {h // 2 for h in halves}
                      if not {2 * sec, 2 * sec + 1} <= halves)
        assert s["sector_bytes"] == 32 * (len(read)
                                          + len({h // 2 for h in halves})
                                          + partial + ids_out)
        assert (partial > 0) == (vb == 16)
        assert g["library"] == "index_select"
        assert s["library"] == gather_scatter.INDEX_PUT
        assert s["library_ms"] > 0 and s["index_copy_ms"] > 0
        assert f"library={gather_scatter.INDEX_PUT}" in s["derived"]
        assert "(no last-write rule)" in s["derived"]


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
    # (collectives, the example here until it was ported, is a module now)
    assert "collectives" in run.MODULES
    with pytest.raises(SystemExit, match="no_such_module"):
        run.main(["--device", "cpu", "--only", "no_such_module"])


def test_microbench_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (run.main, stream.main, gather_scatter.main,
                 gemm_roofline.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
