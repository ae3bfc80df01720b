"""Trainer utilities: events and writers, parameter tables, the environment
report, checkpoint-URL resolution, vis grids."""

from .events import CommonMetricPrinter, EventStorage, JSONWriter, WandbWriter, WriterStack

__all__ = [
    "CommonMetricPrinter",
    "EventStorage",
    "JSONWriter",
    "WandbWriter",
    "WriterStack",
]
