"""Quickstart (port of the reference's ``examples/quickstart.py``): build a
decoder config the port serves, run a forward pass and one train step at
its reduced float32 size.

    python -m repro_torch.examples.quickstart --arch qwen3-32b   # on the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``--arch`` takes the port's configs; the DLRM ones raise
``NotImplementedError`` (they have no reduced size: train them with
``repro_torch.examples.train_dlrm``), as ``build_model`` raises for the
families the port does not build.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import tree as tree_lib
from repro_torch.config import DLRMConfig, get_config, list_configs
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizer import apply_updates
from repro_torch.training.train_step import loss_and_grads


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2-1.5b", choices=list_configs())
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    args = p.parse_args(argv)

    cfg = get_config(args.arch)
    if isinstance(cfg, DLRMConfig):
        raise NotImplementedError(
            f"{cfg.name}: quickstart builds decoders at their reduced size; "
            "train DLRM with repro_torch.examples.train_dlrm")
    print(f"{cfg.name}: {cfg.num_params()/1e9:.2f}B params ({cfg.family})")
    reduced = cfg.reduced(dtype="float32")
    model = build_model(reduced, device=args.device, remat=False)
    params = model.init(0)
    n = sum(x.numel() for x in tree_lib.leaves(params))
    print(f"reduced smoke config: {n/1e6:.2f}M params")

    gen = torch.Generator(device=model.device)
    gen.manual_seed(1)
    toks = torch.randint(0, reduced.vocab_size, (2, 32), generator=gen,
                         device=model.device, dtype=torch.int32)
    with torch.no_grad():
        logits, _ = model.forward(params, toks)
    print("forward:", tuple(logits.shape))

    opt = adamw()
    state = opt.init(params)
    loss, grads = loss_and_grads(model.loss, params, {"tokens": toks})
    upd, state, gnorm = opt.update(grads, state, params, 1e-3)
    params = apply_updates(params, upd)
    print(f"train step: loss={float(loss):.4f} grad_norm={float(gnorm):.3f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
