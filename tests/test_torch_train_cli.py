"""The port's training launcher and examples, in-process on the CPU.

``python -m repro_torch.launch.train --device cpu --reduced`` trains
reduced dense and MoE decoders and prints the reference's lines; with
``--ckpt-dir`` it writes the reference's checkpoint layout at the
reference's cadence (every 200 steps) and ``--resume`` restores the
latest.  The three examples (``quickstart``, ``fault_tolerant_train``,
``train_dlrm``) run with ``--device cpu``; ``train_dlrm``'s loss falls
over its 30 steps (its own assert).  Without a card, the default device
raises.
"""
import math

import pytest
import torch

from repro_torch.examples import fault_tolerant_train, quickstart, train_dlrm
from repro_torch.launch import train

SMALL = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32"]


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_launcher_trains_on_the_cpu(arch, capsys):
    summary = train.main(["--arch", arch, "--steps", "4", *SMALL])
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "done in" in out
    assert math.isfinite(summary["final_loss"])
    assert summary["min_loss"] <= summary["final_loss"]


def test_launcher_checkpoints_and_resumes(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "smollm-360m", "--device", "cpu", "--reduced",
            "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt]
    train.main(["--steps", "200", *args])
    assert (tmp_path / "ckpt" / "step_000000200" / "shard_h0.npz").exists()
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "200"
    capsys.readouterr()
    summary = train.main(["--steps", "2", "--resume", *args])
    out = capsys.readouterr().out
    assert "resumed from step 200" in out
    assert math.isfinite(summary["final_loss"])


def test_launcher_without_a_checkpoint_resumes_from_0(tmp_path, capsys):
    train.main(["--arch", "smollm-360m", "--steps", "2", "--resume",
                "--ckpt-dir", str(tmp_path), *SMALL])
    assert "resumed from step 0" in capsys.readouterr().out


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "qwen2-1.5b"])
def test_quickstart(arch, capsys):
    quickstart.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "forward: (2, 32, 256)" in out and "quickstart OK" in out
    assert "train step: loss=" in out


def test_quickstart_refuses_dlrm():
    with pytest.raises(NotImplementedError, match="train_dlrm"):
        quickstart.main(["--arch", "rm1", "--device", "cpu"])


def test_fault_tolerant_train(capsys):
    fault_tolerant_train.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "phase 2: resumed from step 10" in out
    assert "elastic remesh plan after pod loss: (1, 16, 16)" in out


def test_train_dlrm(capsys):
    first, last = train_dlrm.main(["--device", "cpu"])
    assert last < first
    assert "30 steps in" in capsys.readouterr().out


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for example in (quickstart, fault_tolerant_train, train_dlrm):
        with pytest.raises(RuntimeError, match="cuda"):
            example.main([])
