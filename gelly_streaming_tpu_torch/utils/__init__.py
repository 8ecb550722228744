"""Host-only helpers of the PyTorch port (copies of ``gelly_streaming_tpu.utils``
modules as the ported slices need them)."""
