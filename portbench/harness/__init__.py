"""The harness: what every cell shares. Nothing here names a cell, a
configuration, a mix or a metric: those are found by name (``manifest``)."""
