"""See the package docstring of ``rstnet_tpu_torch``."""
