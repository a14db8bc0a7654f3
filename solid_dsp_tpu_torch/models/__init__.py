"""Demodulators and the composed receive chain."""

from . import fm, qpsk, rx_chain  # noqa: F401
