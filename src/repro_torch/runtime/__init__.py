"""Execution of a Dora plan: the pipeline executor (``pipeline``)."""
