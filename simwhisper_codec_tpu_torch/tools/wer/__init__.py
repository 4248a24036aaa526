"""Twin of the JAX package's ``tools/wer`` CLI (run with ``python -m``)."""
