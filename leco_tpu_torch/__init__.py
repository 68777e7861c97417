"""leco_tpu_torch: the PyTorch + CUDA port of leco_tpu for NVIDIA Hopper.

The JAX package `leco_tpu` stays the reference; this package mirrors it
module for module and imports torch, numpy and einops only."""
