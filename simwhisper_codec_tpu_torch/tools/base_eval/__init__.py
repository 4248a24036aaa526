"""Twin of the JAX package's ``tools/base_eval`` CLI (run with ``python -m``)."""
