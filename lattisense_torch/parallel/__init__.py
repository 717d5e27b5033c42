"""Single-device batched pipelines."""
