"""The port's training launcher and examples, in-process on the CPU.

``python -m repro_torch.launch.train --device cpu --reduced`` trains
reduced dense and MoE decoders, rwkv6, zamba2 and the VLM (on tokens
only, as the reference's launcher) and prints the reference's lines; with
``--ckpt-dir`` it writes the reference's checkpoint layout at the
reference's cadence (every 200 steps) and ``--resume`` restores the
latest.  The three examples (``quickstart``, ``fault_tolerant_train``,
``train_dlrm``) run with ``--device cpu``, the quickstart on every LM
config (zero stub embeddings for the VLM and whisper); ``train_dlrm``'s
loss falls over its 30 steps (its own assert).  Without a card, the default device
raises.
"""
import math

import pytest
import torch

from repro_torch.examples import fault_tolerant_train, quickstart, train_dlrm
from repro_torch.launch import train

SMALL = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32"]


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m",
                                  "rwkv6-1.6b", "zamba2-2.7b",
                                  "internvl2-26b"])
def test_launcher_trains_on_the_cpu(arch, capsys):
    summary = train.main(["--arch", arch, "--steps", "4", *SMALL])
    out = capsys.readouterr().out
    assert "step     0  loss" in out and "done in" in out
    assert math.isfinite(summary["final_loss"])
    assert summary["min_loss"] <= summary["final_loss"]


def _trainers(monkeypatch, every=None):
    """The Trainers the launcher builds, recorded; ``every`` overrides
    their checkpoint cadence."""
    built = []
    real = train.Trainer

    def make(**kw):
        t = real(**kw)
        if every is not None:
            t.checkpoint_every = every
        built.append(t)
        return t

    monkeypatch.setattr(train, "Trainer", make)
    return built


def test_launcher_checkpoints_at_the_reference_cadence(tmp_path,
                                                       monkeypatch):
    built = _trainers(monkeypatch)
    train.main(["--arch", "smollm-360m", "--steps", "1", "--ckpt-dir",
                str(tmp_path), *SMALL])
    assert [t.checkpoint_every for t in built] == [200]
    assert built[0].ckpt is not None


def test_launcher_checkpoints_and_resumes(tmp_path, capsys, monkeypatch):
    # the round trip at a cadence of 4 steps (the launcher's is 200:
    # the test above), so it trains 4 steps, not 200
    _trainers(monkeypatch, every=4)
    ckpt = str(tmp_path / "ckpt")
    args = ["--arch", "smollm-360m", "--device", "cpu", "--reduced",
            "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt]
    train.main(["--steps", "4", *args])
    assert (tmp_path / "ckpt" / "step_000000004" / "shard_h0.npz").exists()
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "4"
    capsys.readouterr()
    summary = train.main(["--steps", "2", "--resume", *args])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
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


@pytest.mark.parametrize("arch,positions", [
    ("rwkv6-1.6b", 32), ("zamba2-2.7b", 32), ("whisper-tiny", 32),
    ("internvl2-26b", 40), ("llama31-8b", 32), ("qwen3-32b", 32),
    ("internlm2-20b", 32), ("llama31-70b", 32), ("qwen3-moe-235b-a22b", 32)])
def test_quickstart_other_configs(arch, positions, capsys):
    """Every LM config the first test leaves out; the VLM's 8 vision-stub
    positions come first in its logits."""
    quickstart.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"forward: (2, {positions}, 256)" in out
    loss = float(out.split("train step: loss=")[1].split()[0])
    assert math.isfinite(loss) and "quickstart OK" in out


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
