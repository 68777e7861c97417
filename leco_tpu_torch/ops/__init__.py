"""Kernels and operators: attention, flash attention, the fused conv,
GroupNorm-conv, GroupNorm and GEGLU kernels, schedulers."""
