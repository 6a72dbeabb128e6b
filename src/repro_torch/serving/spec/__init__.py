"""Speculative decoding of the port: draft-propose / batch-verify /
rejection-accept (port of ``repro.serving.spec``).

* :mod:`~repro_torch.serving.spec.proposer` — the :class:`Proposer` base
  and its string-keyed registry;
* :mod:`~repro_torch.serving.spec.ngram` / :mod:`~repro_torch.serving.
  spec.draft_model` — the ``ngram`` and ``draft-model`` proposers;
* :mod:`~repro_torch.serving.spec.verify` — batched verify and the
  rejection-accept rule.
"""
from repro_torch.serving.spec.proposer import (        # noqa: F401
    ALIASES, DEFAULT, OFF, Proposer, UnknownProposerError, force_proposer,
    forced_proposer, get, names, record_resolutions, register, resolve)
from repro_torch.serving.spec import ngram, draft_model  # noqa: F401
from repro_torch.serving.spec.ngram import NgramProposer          # noqa: F401
from repro_torch.serving.spec.draft_model import (                # noqa: F401
    DraftModelProposer)
from repro_torch.serving.spec.verify import verify_batched        # noqa: F401

__all__ = [
    "ALIASES", "DEFAULT", "OFF", "Proposer", "UnknownProposerError",
    "force_proposer", "forced_proposer", "get", "names",
    "record_resolutions", "register", "resolve", "NgramProposer",
    "DraftModelProposer", "verify_batched",
]
