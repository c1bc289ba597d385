"""Measurement scripts of the port, run as `python -m seaweedfs_tpu_torch.scripts.<name>`."""
