"""Weight and data tools, run with ``python -m``."""
