"""One reader a metric, ``read(window) -> value or None``, found by the
metric's name.  None means there was nothing to read, and the metric is
left out of the result."""
