"""Composed chains."""

from . import rx_chain  # noqa: F401
