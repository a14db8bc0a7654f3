"""Demodulators and the FM broadcast-stereo back end, the front-end
impairment correction, the composed receive chain, the digital
down-converter (DDC), the config-5 channel models (the channelizer banks,
ChannelBank, SpectrumMonitor and the burst detector's pieces), ROADMAP
item 13a (the linear modems, frame sync, LDPC, polar and turbo codes, DPD,
CFR, the adaptive equalizers, the radar kit) and item 13b, the link layer:
convolutional FEC, block codes, Reed-Solomon, CCSDS, the channel models,
BER simulation, OFDM, the packet and OFDM modems, MIMO and array
processing; the modems and receivers of item 13c: AM, GMSK, FSK, CSS,
DSSS, FHSS, CW, CVSD, symbol timing, ADS-B, AIS and the transmit chain; and
its protocol decoders and measurement tools: POCSAG, RDS, DTMF, the
modulation classifier and the channel sounder."""

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
from . import (array_proc, ber, block_codes, ccsds, fec,  # noqa: F401
               mimo, ofdm, ofdm_link, ofdm_pilots, packet, rs)
from .block_codes import BlockCode  # noqa: F401
from .ber import ber_sweep, link_sim  # noqa: F401
from .packet import PacketModem  # noqa: F401
from .ofdm_link import OFDMModem  # noqa: F401
from . import (adsb, ais, am, css, cvsd, cw, dsss, fhss,  # noqa: F401
               fsk, gmsk, timing, tx_chain)
from .tx_chain import TxChain, TxChainConfig  # noqa: F401
from . import dtmf, modclass, pocsag, rds, sounder  # noqa: F401
