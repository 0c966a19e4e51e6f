import orbit2_tpu_torch.transforms.transforms  # noqa: F401  (populate registry)
