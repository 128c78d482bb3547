"""PyTorch / CUDA port of the `repro` package, for one NVIDIA H100.

Mirrors `src/repro/` module by module and imports nothing of it (nor of
JAX). The JAX package stays the reference; `tests/test_torch_*.py` hold
this package to it on the CPU, and `chip_smoke.py` drives it on the card.
Entry points run on CUDA unless the caller passes device="cpu".
"""
