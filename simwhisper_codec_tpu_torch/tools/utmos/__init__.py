"""Twin of the JAX package's ``tools/utmos`` CLI (run with ``python -m``)."""
