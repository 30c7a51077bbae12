"""See the package docstring of adaptigraph_tpu_torch."""
