import orbit2_tpu_torch.metrics.metrics  # noqa: F401  (populate registry)
