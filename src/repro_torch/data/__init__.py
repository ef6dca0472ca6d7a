"""The synthetic token pipeline (``pipeline``)."""
