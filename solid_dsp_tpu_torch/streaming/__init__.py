"""Streaming: the chain's carried state and its checkpoints, and the
overlap-save framing the filters share."""

from . import framing, state  # noqa: F401
