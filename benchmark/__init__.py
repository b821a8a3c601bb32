"""The benchmark of vpin_tpu_torch: see README.md."""
