"""Command-line entry points of the port: ``decode`` and ``serve``, and
``train.build_model``."""
