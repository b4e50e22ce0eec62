"""Data parallelism over processes (:mod:`tcs_tpu_torch.parallel.mesh`)."""
