"""Command-line tools of the port, run with `python -m leco_tpu_torch.scripts.<name>`."""
