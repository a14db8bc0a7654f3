"""Demodulators, the front-end impairment correction, the composed receive
chain, and the config-5 channel models: the channelizer banks,
ChannelBank, SpectrumMonitor and the burst detector's pieces."""

from . import (channel_bank, channelizer, detect, fm, impairments,  # noqa: F401
               monitor, qpsk, rx_chain)
