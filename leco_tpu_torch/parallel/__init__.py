"""Data, tensor and spatial parallelism of the train step over
torch.distributed (the JAX package's `leco_tpu/parallel/`)."""
