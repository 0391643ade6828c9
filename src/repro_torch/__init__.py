"""PyTorch port of the ``repro`` serving path, for NVIDIA Hopper GPUs.

The layout mirrors ``src/repro/`` module for module so each function's
JAX counterpart is easy to find.  The port imports ``torch`` and never
JAX or the ``repro`` package: what it needs from there it keeps as its own
copy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU present and the CPU not asked for they raise
(:func:`repro_torch.device.resolve_device`).
"""
