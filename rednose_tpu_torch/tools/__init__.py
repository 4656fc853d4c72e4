"""Command-line tools of the port (python -m rednose_tpu_torch.tools.<name>)."""
