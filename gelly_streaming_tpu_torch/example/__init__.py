"""Example CLIs of the PyTorch port (``python -m
gelly_streaming_tpu_torch.example.<name>``)."""
