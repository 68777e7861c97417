"""Kernels and operators: attention, flash attention, schedulers."""
