"""PyTorch/CUDA port of the Gaunt tensor product system for the NVIDIA H100.

Imports torch and numpy only, never JAX or the reference package `repro`.
Entry points run on CUDA unless given ``device="cpu"``.
"""
