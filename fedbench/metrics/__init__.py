"""Per-layer metric readers, one file a metric: ``<name>.py`` with
``read(ctx)``, or for ``<arg>_<family>`` a family reader ``<family>.py``
with ``read(ctx, arg)``. A reader that finds nothing to read returns
None, and the metric is left out of the result line."""
