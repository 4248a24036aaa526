"""Training recipes, run with ``python -m``."""
