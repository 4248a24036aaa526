"""One module per model a configuration file names under ``model``: each gives
``parameter_count(cfg)``, the parameters the configuration holds,
``widths(cfg)``, its depths and widths under the names its ``published``
entry uses, and ``CUTTABLE``, the names of those sizes that a configuration
may cut (``reduced``): depths and the share of the model that one chip
holds (layers, experts held, a vocabulary slice), never a width.  They
import nothing of the program."""
