"""The share of the traced stretch in which no operation ran on the card
(``harness/readers.py``)."""

from harness.readers import idle_pct as read  # noqa: F401
