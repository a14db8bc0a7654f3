"""Demodulators, the composed receive chain, and the config-5 channel
models: the channelizer banks, ChannelBank, SpectrumMonitor and the burst
detector's pieces."""

from . import (channel_bank, channelizer, detect, fm, monitor, qpsk,  # noqa: F401
               rx_chain)
