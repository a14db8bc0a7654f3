"""Demodulators and the FM broadcast-stereo back end, the front-end
impairment correction, the composed receive chain, the digital
down-converter (DDC), and the config-5 channel models: the channelizer
banks, ChannelBank, SpectrumMonitor and the burst detector's pieces."""

from . import (channel, channel_bank, channelizer, ddc, detect,  # noqa: F401
               fm, impairments, monitor, qpsk, rx_chain)
