"""Disaggregated prefill/decode serving (port of ``repro.serving.disagg``).

A prefill-role :class:`~repro_torch.serving.engine.ServingEngine` fills KV
blocks, a decode engine consumes them; :class:`DisaggEngine` is the
frontend that routes each request from one to the other, with the block
transfer expressed through the allocator's public reserve/commit API.
"""
from repro_torch.serving.disagg.frontend import (DisaggEngine,
                                                 copy_block_tokens,
                                                 parse_roles)

__all__ = ["DisaggEngine", "copy_block_tokens", "parse_roles"]
