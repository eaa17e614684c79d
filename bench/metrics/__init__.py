"""One reader a per-layer metric, ``<name>.py`` with ``read(ctx)``: the
metric from the window's counts, spans and trace (``harness.run``'s
``ctx``), or None where the run gave it nothing to read."""
