"""ADS-B / Mode S (1090 MHz) decoder: PPM demodulation, preamble
detection, CRC-24.

Port of ``solid_dsp_tpu/models/adsb.py``.  A DF17 extended squitter is an
8 us preamble (pulses at 0, 1, 3.5 and 4.5 us) then 112 pulse-position
bits (1 us a bit: energy in the first half is a 1); its last 24 bits are
the remainder of the first 88 by the Mode S generator 0x1FFF409, so a
clean frame's whole remainder is 0.  The CRC-24 of a batch of frames is
one GF(2) product with an (112, 24) matrix (``utils/bits.py::gf2_matmul``:
a float32 product, exact, since the card's matmul takes no int32); the PPM
demodulation a reshape and a half-energy compare; the preamble score a
normalised correlation of the power envelope with the 16-chip mask
(``conv1d_mxu``).  Those run on the card; the frame walk (peak picking)
stays on the host, as in the JAX package (:123-169).  :func:`decode`
demodulates and checks every frame it found in one batch (JAX: one
dispatch a frame) and reads the results back once.  The CRC matrix
builder is the port's own copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant, resolve_device
from ..ops.fir import conv1d_mxu
from ..utils.bits import gf2_matmul

__all__ = ["MODE_S_GENERATOR", "crc24_remainder", "encode_df17",
           "ppm_modulate", "ppm_demod_frame", "preamble_score",
           "detect_preambles", "decode"]

MODE_S_GENERATOR = 0x1FFF409          # 25 bits: x^24 + ... + 1
_PREAMBLE_CHIPS = np.array([1, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0],
                           np.float64)  # 0.5 us chips over the 8 us preamble


def _crc_matrix(n_data: int = 88) -> np.ndarray:
    """R (n_data, 24): remainder = bits @ R mod 2, bits in wire order (row
    i: x^(n_data - 1 - i + 24) mod g by long division)."""
    R = np.zeros((n_data, 24), np.int64)
    for i in range(n_data):
        deg = n_data - 1 - i + 24
        r = 1 << deg
        for d in range(deg, 23, -1):
            if r >> d & 1:
                r ^= MODE_S_GENERATOR << (d - 24)
        R[i] = [(r >> (23 - b)) & 1 for b in range(24)]
    return R


_R88 = _crc_matrix(88)
# the whole frame's check: message x^24 mod g is 0 iff the frame is valid
_R112 = _crc_matrix(112)


def crc24_remainder(bits112) -> torch.Tensor:
    """(..., 112) wire-order bits -> (..., 24) remainder (int32; all zero
    for a valid DF17 frame): one GF(2) product."""
    b = torch.as_tensor(bits112)
    return gf2_matmul(b, device_constant(_R112.astype(np.float32), b.device))


def encode_df17(icao: int, me_bits) -> np.ndarray:
    """A 112-bit DF17 frame (host numpy int32): DF = 17, CA = 5, the ICAO
    address, the 56-bit ME field, the parity."""
    me = np.asarray(me_bits, np.int64).reshape(56)
    head = ([(17 >> (4 - i)) & 1 for i in range(5)]
            + [(5 >> (2 - i)) & 1 for i in range(3)])
    icao_bits = [(int(icao) >> (23 - i)) & 1 for i in range(24)]
    data = np.asarray(head + icao_bits + me.tolist(), np.int64)
    return np.concatenate([data, data @ _R88 % 2]).astype(np.int32)


def ppm_modulate(bits112, sps: int = 2) -> np.ndarray:
    """Frame bits -> the unit-amplitude envelope (preamble + PPM data),
    host numpy float32; ``sps`` samples a 0.5 us chip."""
    b = np.asarray(bits112, np.int64).reshape(-1)
    chips = np.empty(2 * len(b), np.float64)
    chips[0::2] = b            # first half-bit pulse for a 1
    chips[1::2] = 1 - b        # second half for a 0
    return np.repeat(np.concatenate([_PREAMBLE_CHIPS, chips]),
                     sps).astype(np.float32)


def ppm_demod_frame(power, sps: int = 2):
    """(..., 224 sps) data-section power -> ((..., 112) bits int32,
    confidence), confidence the mean |E1 - E2| / (E1 + E2) (1 for clean
    PPM)."""
    p = torch.as_tensor(power)
    v = p.reshape(*p.shape[:-1], 112, 2, sps).sum(dim=-1)
    e1, e2 = v[..., 0], v[..., 1]
    conf = torch.mean(torch.abs(e1 - e2) / (e1 + e2 + 1e-20), dim=-1)
    return (e1 > e2).to(torch.int32), conf


def preamble_score(power, sps: int = 2) -> torch.Tensor:
    """score[t] = the energy in the 4 preamble pulse chips over the energy
    of the 16-chip window starting at sample t (~0.95 at a preamble, ~4/16
    on noise)."""
    p = torch.as_tensor(power)
    mask = np.repeat(_PREAMBLE_CHIPS, sps)
    # conv1d_mxu correlates: the mask in wire order, not reversed
    on = conv1d_mxu(p, device_constant(mask, p.device, p.dtype))
    total = conv1d_mxu(p, device_constant(np.ones(len(mask)), p.device,
                                          p.dtype))
    return on / (total + 1e-20)


def _pick(score: np.ndarray, n: int, sps: int, threshold: float,
          limit: int) -> np.ndarray:
    """The host frame walk: candidates above the threshold, one a frame
    span; a later candidate replaces the span's start where it scores
    higher, leaves room for a frame and lies within the start's preamble.
    F10: JAX's walk (``solid_dsp_tpu/models/adsb.py:133-143``) lets any
    candidate of the span replace it, so a window over the frame's last
    pulses and quieter noise after them takes the frame's start."""
    n_pre = 16 * sps
    frame = n_pre + 224 * sps
    starts = []
    for t in np.nonzero(score > threshold)[0]:
        if len(starts) >= limit:
            break
        if starts and t - starts[-1] < frame:
            if (t - starts[-1] < n_pre and score[t] > score[starts[-1]]
                    and int(t) + frame <= n):
                starts[-1] = int(t)
            continue
        if int(t) + frame <= n:
            starts.append(int(t))
    return np.asarray(starts, np.int64)


def detect_preambles(power, sps: int = 2, threshold: float = 0.7,
                     limit: int = 256, device=None) -> np.ndarray:
    """Start indices of the detected frames (host peak picking on the
    score, computed on ``device``: the card unless told otherwise, or
    where a tensor ``power`` lies)."""
    p = (power if isinstance(power, torch.Tensor)
         else torch.from_numpy(np.asarray(power, np.float32)).to(
             resolve_device(device)))
    score = preamble_score(p, sps).cpu().numpy()
    return _pick(score, p.shape[-1], sps, threshold, limit)


def decode(x, sps: int = 2, threshold: float = 0.7, limit: int = 256,
           device=None) -> list:
    """IQ or power stream -> the decoded frames (at most ``limit``), each
    dict(start, df, icao, bits, crc_ok, confidence).  Complex IQ becomes
    power; real input is taken as power.  Runs on ``device`` (the card
    unless told otherwise)."""
    x = np.asarray(x)
    power = ((np.abs(x) ** 2).astype(np.float32) if np.iscomplexobj(x)
             else x.astype(np.float32))
    p = torch.from_numpy(power).to(resolve_device(device))
    starts = detect_preambles(p, sps, threshold, limit)
    if not len(starts):
        return []
    n_pre = 16 * sps
    idx = torch.from_numpy(starts + n_pre).to(p.device)[:, None] + \
        torch.arange(224 * sps, device=p.device)
    bits, conf = ppm_demod_frame(p[idx], sps)
    rem = crc24_remainder(bits).any(dim=-1)
    bits, conf, rem = bits.cpu().numpy(), conf.cpu().numpy(), \
        rem.cpu().numpy()
    out = []
    for t, b, c, bad in zip(starts, bits, conf, rem):
        out.append({"start": int(t),
                    "df": int(b[:5] @ (1 << np.arange(4, -1, -1))),
                    "icao": int(b[8:32] @ (1 << np.arange(23, -1, -1,
                                                          dtype=np.int64))),
                    "bits": b, "crc_ok": not bool(bad),
                    "confidence": float(c)})
    return out
