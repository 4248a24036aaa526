"""Host-side logging setup (reference ``utils/helpers.py:60-75``)."""

from __future__ import annotations

import logging
import os


def set_logging(level=logging.INFO) -> None:
    """RANK-tagged logging format."""
    rank = int(os.environ.get("RANK", 0))
    logging.basicConfig(
        level=level,
        format=f"%(asctime)s [RANK {rank}] (%(module)s:%(lineno)d) %(levelname)s : %(message)s",
        force=True,
    )
