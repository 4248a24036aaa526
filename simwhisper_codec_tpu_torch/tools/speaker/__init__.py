"""Twin of the JAX package's ``tools/speaker`` CLI (run with ``python -m``)."""
