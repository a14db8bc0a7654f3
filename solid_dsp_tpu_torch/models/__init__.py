"""Demodulators and the FM broadcast-stereo back end, the front-end
impairment correction, the composed receive chain, the digital
down-converter (DDC), the config-5 channel models (the channelizer banks,
ChannelBank, SpectrumMonitor and the burst detector's pieces), and ROADMAP
item 13a: the linear modems, frame sync, LDPC, polar and turbo codes, DPD,
CFR, the adaptive equalizers and the radar kit."""

from . import (channel, channel_bank, channelizer, ddc, detect,  # noqa: F401
               fm, impairments, monitor, qpsk, rx_chain)
from .rx_chain import RxChain, RxChainConfig  # noqa: F401
from .channelizer import PolyphaseChannelizer, OversampledChannelizer  # noqa: F401
from .channel_bank import ChannelBank  # noqa: F401
from . import (cfr, dpd, equalizer, framesync, ldpc, linear_mod,  # noqa: F401
               polar, radar, turbo)
from .ldpc import LDPCCode  # noqa: F401
from .turbo import TurboCode  # noqa: F401
from .linear_mod import LinearModem  # noqa: F401
