"""PyTorch/CUDA port of the early-exit Conformer ASR inference path.

A second package beside `early_exit_tpu` (JAX/Pallas). Module names
mirror the JAX package so each counterpart is easy to find; tensors keep
its feature-last (B, T, C) layout and its weight layouts. Entry points
run on CUDA unless the caller passes `device="cpu"`. The package imports
`torch`, never `jax`, and nothing of `early_exit_tpu`.
"""
