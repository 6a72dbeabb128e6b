"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` is the reference; this package imports nothing of
it and never imports ``jax``.  Entry points run on the card unless the
caller passes ``device="cpu"`` (see :func:`repro_torch.device.resolve`).
"""
