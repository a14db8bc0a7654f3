"""AIS (marine automatic identification system) receiver: GMSK at 9600
baud, NRZI, HDLC framing, CRC-16/X.25, on the port's GMSK modem.

Port of ``solid_dsp_tpu/models/ais.py`` (ITU-R M.1371: GMSK BT = 0.4, NRZI
where a 0 toggles the line and a 1 holds it, HDLC flags 0x7E with a 0
stuffed after five ones, the 16-bit X.25 FCS least significant bit first).
The sample-rate DSP (``gmsk_modulate``, ``gmsk_demod_discriminator``)
runs on ``device``, the card unless told otherwise; the bit-level framing
(NRZI, flag search, destuffing, the FCS) is host numpy, variable-length by
nature, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils import bits as B
from . import gmsk

__all__ = ["crc16_x25_bits", "nrzi_encode", "nrzi_decode", "hdlc_stuff",
           "hdlc_destuff", "ais_build_frame", "ais_transmit",
           "ais_find_frames", "ais_receive", "build_type1_payload",
           "parse_type123"]

FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], np.int8)
TRAINING = np.tile([0, 1], 12).astype(np.int8)


def crc16_x25_bits(payload_bits) -> np.ndarray:
    """The X.25 FCS (poly 0x1021, init 0xFFFF, reflected, xorout 0xFFFF)
    of wire-order bits, as 16 bits least significant first (HDLC order):
    bit i of the reflected value is bit 15 - i of the unreflected fold."""
    v = int(B.crc_compute(torch.from_numpy(np.asarray(payload_bits,
                                                      np.int32)),
                          poly=0x1021, width=16, init=0xFFFF,
                          xorout=0xFFFF, reflected=False))
    return ((v >> (15 - np.arange(16))) & 1).astype(np.int8)


def nrzi_encode(bits, initial: int = 0) -> np.ndarray:
    """AIS NRZI: a 0 toggles the level, a 1 keeps it."""
    toggles = 1 - np.asarray(bits, np.int8)
    return ((initial + np.cumsum(toggles)) % 2).astype(np.int8)


def nrzi_decode(levels, initial: int = 0) -> np.ndarray:
    """The inverse of :func:`nrzi_encode`: 1 where the level held."""
    lv = np.asarray(levels, np.int8)
    prev = np.concatenate([[initial], lv[:-1]])
    return (lv == prev).astype(np.int8)


def hdlc_stuff(bits) -> np.ndarray:
    """A 0 inserted after every run of five 1s."""
    out = []
    run = 0
    for b in np.asarray(bits, np.int8):
        out.append(int(b))
        run = run + 1 if b else 0
        if run == 5:
            out.append(0)
            run = 0
    return np.asarray(out, np.int8)


def hdlc_destuff(bits) -> np.ndarray:
    """The stuffed 0 after every run of five 1s removed."""
    out = []
    run = 0
    skip = False
    for b in np.asarray(bits, np.int8):
        if skip:
            skip = False
            run = 0
            continue
        out.append(int(b))
        run = run + 1 if b else 0
        if run == 5:
            skip = True
    return np.asarray(out, np.int8)


def ais_build_frame(payload_bits) -> np.ndarray:
    """training ++ flag ++ stuff(payload ++ FCS) ++ flag (wire bits)."""
    p = np.asarray(payload_bits, np.int8)
    body = np.concatenate([p, crc16_x25_bits(p)])
    return np.concatenate([TRAINING, FLAG, hdlc_stuff(body), FLAG])


def ais_transmit(payload_bits, sps: int = 8, bt: float = 0.4,
                 device=None) -> np.ndarray:
    """Payload bits -> a complex GMSK baseband burst with a settling tail
    (host numpy complex64), modulated on ``device``."""
    levels = nrzi_encode(ais_build_frame(payload_bits))
    tx_bits = np.concatenate([levels, np.full(16, levels[-1], np.int8)])
    dev = resolve_device(device)
    iq, _ = gmsk.gmsk_modulate(gmsk.gmsk_mod_init(bt, sps, device=dev),
                               torch.from_numpy(tx_bits.astype(np.int32)).to(
                                   dev), sps, bt)
    return iq.cpu().numpy()


def ais_find_frames(decoded_bits) -> list:
    """The destuffed bodies between HDLC flags: a list of (payload_bits,
    crc_ok)."""
    b = np.asarray(decoded_bits, np.int8)
    if len(b) < 8:
        return []
    w = np.lib.stride_tricks.sliding_window_view(b, 8)
    flags = np.nonzero((w == FLAG).all(axis=1))[0]
    out = []
    for a, z in zip(flags[:-1], flags[1:]):
        body = b[a + 8: z]
        if len(body) < 24:            # shorter than an FCS: not a frame
            continue
        ds = hdlc_destuff(body)
        if len(ds) < 24:
            continue
        payload, fcs = ds[:-16], ds[-16:]
        out.append((payload, bool((crc16_x25_bits(payload) == fcs).all())))
    return out


def ais_receive(iq, sps: int = 8, bt: float = 0.4, device=None) -> list:
    """Complex baseband -> a list of (payload_bits, crc_ok): the GMSK
    discriminator on ``device`` (the card unless told otherwise), then NRZI
    decoding, the flag search, destuffing and the FCS on the host."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(iq, np.complex64)).to(dev)
    T = (x.shape[-1] // sps) * sps
    levels, _ = gmsk.gmsk_demod_discriminator(
        gmsk.gmsk_demod_init(bt, sps, device=dev), x[:T], sps, bt)
    return ais_find_frames(nrzi_decode(levels.cpu().numpy()))


def _put(bits, pos, width, value):
    v = int(value) & ((1 << width) - 1)
    bits[pos: pos + width] = [(v >> (width - 1 - i)) & 1
                              for i in range(width)]


def build_type1_payload(mmsi: int, lat_deg: float, lon_deg: float,
                        sog_knots: float = 0.0, cog_deg: float = 0.0
                        ) -> np.ndarray:
    """A minimal AIS type-1 position report (168 bits, ITU-R M.1371
    §3.3)."""
    bits = np.zeros(168, np.int8)
    _put(bits, 0, 6, 1)                                  # message type
    _put(bits, 8, 30, mmsi)
    _put(bits, 50, 10, round(sog_knots * 10))
    _put(bits, 61, 28, round(lon_deg * 600000) & ((1 << 28) - 1))
    _put(bits, 89, 27, round(lat_deg * 600000) & ((1 << 27) - 1))
    _put(bits, 116, 12, round(cog_deg * 10))
    return bits


def _get(bits, pos, width, signed=False):
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    if signed and v >> (width - 1):
        v -= 1 << width
    return v


def parse_type123(payload) -> dict:
    """The common fields of AIS position reports (types 1-3)."""
    p = np.asarray(payload, np.int8)
    return {
        "type": _get(p, 0, 6),
        "mmsi": _get(p, 8, 30),
        "sog_knots": _get(p, 50, 10) / 10.0,
        "lon_deg": _get(p, 61, 28, signed=True) / 600000.0,
        "lat_deg": _get(p, 89, 27, signed=True) / 600000.0,
        "cog_deg": _get(p, 116, 12) / 10.0,
    }
