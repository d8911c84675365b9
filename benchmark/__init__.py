"""The benchmark of spllt_tpu_torch: one cell (configuration × traffic mix)
per run, driven through the package's public API.  See README.md."""
