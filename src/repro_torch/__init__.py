"""PyTorch + CUDA port of the DevFT system for one NVIDIA H100.

The JAX package ``repro`` is the reference this package is held
against; this package imports ``torch`` and ``numpy`` and nothing of
JAX or of ``repro``. Module paths mirror ``repro`` so each counterpart
is easy to find. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""
