"""The training step's share of the card's bf16 peak over the traced
stretch (``harness/readers.py``)."""

from harness.readers import train_mfu as read  # noqa: F401
