"""The port's one-card dry run (``repro_torch.launch.dryrun``) on the CPU:
every cell of reduced configs, with ``SHAPES`` cut small as the reference's
own integration test cuts them, counts ``ok`` with a bottleneck among the
three terms and depth probes that extrapolate exactly; smollm-360m's train
step has a useful-FLOPs ratio in (0.5, 1.2]; ``--multi-pod`` writes
``ok`` records for rank 0 of the 2x16x16 mesh beside the one-card
default; ``SKIP`` is the reference's."""
import ast
import json
from pathlib import Path

import pytest

import repro_torch.launch.dryrun as dr
from repro_torch.config import ShapeCell, get_config
from repro_torch.configs import ASSIGNED_LM_ARCHS

SMALL = {
    "train_4k": ShapeCell("train_4k", 256, 8, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 1024, 4, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 1024, 8, "decode"),
    "long_500k": ShapeCell("long_500k", 2048, 1, "decode"),
}
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(dr, "SHAPES", SMALL)
    monkeypatch.setattr(dr, "get_config", lambda a: get_config(a).reduced())


@pytest.mark.parametrize("arch", ASSIGNED_LM_ARCHS)
def test_every_cell_counts_with_exact_probes(small, arch):
    for shape in SMALL:
        rec = dr.run_cell(arch, shape, probes=True, verbose=False)
        if (arch, shape) in dr.SKIP:
            assert rec["status"] == "skipped"
            continue
        assert rec["status"] == "ok", rec
        assert rec["mesh"] == "1" and rec["roofline"]["chips"] == 1
        rl = rec["roofline"]
        assert rl["hlo_flops"] > 0 and rl["hlo_bytes"] > 0
        assert rl["bottleneck"] in ("compute", "memory", "collective")
        assert rec["probe_flops_rel_err"] <= dr.PROBE_RTOL
        assert rec["probe_d2"]["flops"] > rec["probe_d1"]["flops"] > 0
        assert rl["hlo_flops"] == rec["full"]["flops"]


def test_dense_train_useful_flops_ratio(small):
    rec = dr.run_cell("smollm-360m", "train_4k", probes=True, verbose=False)
    assert 0.5 < rec["roofline"]["useful_flops_ratio"] <= 1.2


def test_multi_pod_writes_ok_records(small, tmp_path):
    # rank 0 of the 2x16x16 production mesh, counted on the meta device;
    # the one-card count stays the default
    assert dr.main(["--arch", "smollm-360m", "--shape", "train_4k",
                    "--multi-pod", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "smollm-360m__train_4k__2x16x16.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["roofline"]["chips"] == 512
    assert rec["roofline"]["collective_bytes"] > 0
    one = dr.run_cell("smollm-360m", "train_4k", multi_pod=True,
                      verbose=False)
    assert one["roofline"]["hlo_flops"] == rec["roofline"]["hlo_flops"]
    assert dr.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                    "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "smollm-360m__decode_32k__1.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["roofline"]["mesh"] == "1"
    assert rec["roofline"]["collective_bytes"] == 0


def test_skip_is_the_reference():
    # read from the source: importing the reference's dry run would set
    # its 512-device XLA flags in this process
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    skip = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "SKIP")
    assert dr.SKIP == skip


def test_cells_counted_in_processes_equal_the_serial_count(small, tmp_path):
    # main counts the cells in a pool of workers, one a core; the configs
    # and shapes are read in this process (patched small) and handed to
    # the workers
    assert dr.main(["--all", "--arch", "qwen2-1.5b", "--out",
                    str(tmp_path)]) == 0
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(tmp_path.glob("*.json"))}
    assert len(recs) == len(SMALL)
    for shape in SMALL:
        serial = json.loads(json.dumps(
            dr.run_cell("qwen2-1.5b", shape, verbose=False), default=float))
        rec = recs[f"qwen2-1.5b__{shape}__1.json"]
        assert rec["status"] == serial["status"]
        if rec["status"] == "ok":
            assert rec["full"] == serial["full"]
            assert rec["roofline"] == serial["roofline"]
