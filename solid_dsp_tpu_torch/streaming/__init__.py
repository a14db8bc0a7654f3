"""Streaming state: the chain's carried state and its checkpoints."""

from . import state  # noqa: F401
