"""Adafactor-lite (port of ``repro.optim.adafactor``): factored second
moments for parameters of two or more dimensions (a row factor over the
last axis, a column factor over the one before), a full second moment
for the others, RMS-scaled steps and update clipping (Shazeer and Stern,
2018), no momentum.  A leaf that is not floating point gets a zero update
(the reference raises); the factors are new tensors each step."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.optim.optimizer import Optimizer, _clip_or_widen, _device


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any          # row factors (or full v for 1-D params)
    vc: Any          # col factors (zeros(0,) for 1-D)


def _factored(p) -> bool:
    return p.dim() >= 2


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              grad_clip: Optional[float] = 1.0) -> Optimizer:
    def init(params):
        def vr_init(p):
            shape = p.shape[:-1] if _factored(p) else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc_init(p):
            shape = (p.shape[:-2] + p.shape[-1:] if _factored(p) else (0,))
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            vr=tree_lib.map(vr_init, params),
            vc=tree_lib.map(vc_init, params))

    def update(grads, state: AdafactorState, params, lr):
        grads, gnorm = _clip_or_widen(grads, grad_clip, None, None)
        step = state.step + 1
        beta2 = 1.0 - step.float() ** -decay_pow

        def upd(g, vr, vc, p):
            if not p.is_floating_point():
                return torch.zeros_like(p), vr, vc
            g2 = g * g + eps
            if _factored(p):
                vr_n = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
                vc_n = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    vr_n[..., None] * vc_n[..., None, :]
                    / torch.clamp_min(vr_n.mean(-1, keepdim=True)[..., None],
                                      eps))
            else:
                vr_n = beta2 * vr + (1 - beta2) * g2
                vc_n = vc
                denom = torch.sqrt(vr_n)
            u = g / torch.clamp_min(denom, eps)
            # update clipping: RMS(u) <= clip_threshold
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                u = u + weight_decay * p.detach().float()
            return (-lr * u).to(p.dtype), vr_n, vc_n

        flat_p, structure = tree_lib.flatten(params)
        out = [upd(*xs) for xs in zip(tree_lib.leaves(grads),
                                      tree_lib.leaves(state.vr),
                                      tree_lib.leaves(state.vc), flat_p)]
        pick = lambda i: tree_lib.unflatten(  # noqa: E731
            structure, [o[i] for o in out])
        return pick(0), AdafactorState(step, pick(1), pick(2)), gnorm

    return Optimizer(init=init, update=update)
