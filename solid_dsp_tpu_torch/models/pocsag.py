"""POCSAG pager decoder: 2-FSK + BCH(31,21) + batch framing.

Port of ``solid_dsp_tpu/models/pocsag.py``.  Protocol per ITU-R M.584: a
576-bit 1/0 preamble, then batches of one sync codeword (0x7CD215D8) + 16
codewords of 32 bits.  Each codeword = BCH(31,21) (generator
x^10+x^9+x^8+x^6+x^5+x^3+1) + even parity; bit 0 tells an address (0) from
a message (1) codeword.  Addresses carry 18 address bits + 2 function
bits; alphanumeric messages pack 7-bit ASCII LSB-first across the 20-bit
message fields.

The sample-rate DSP (the CPFSK discriminator, ``fsk.py``) runs where the
input lies, and its symbols come back to the host in one copy; framing
and the BCH(31,21) syndrome decode (2-error-correcting through a
precomputed syndrome -> error-pattern table of 496 entries) are host bit
twiddling over a handful of 32-bit words a batch, as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import fsk
from .fm import fm_demod_init

__all__ = ["bch3121_encode", "bch3121_syndrome_decode", "pocsag_encode",
           "pocsag_transmit", "pocsag_decode_bits", "pocsag_receive",
           "SYNC_WORD", "IDLE_WORD"]

BCH_GEN = 0b11101101001          # x^10+x^9+x^8+x^6+x^5+x^3+1 (deg 10)
SYNC_WORD = 0x7CD215D8
IDLE_WORD = 0x7A89C197


def _bch_remainder(data21: int) -> int:
    """Remainder of data(x) * x^10 by the BCH generator (ints, host)."""
    return _syndrome31(data21 << 10)


def bch3121_encode(data21: int) -> int:
    """21 data bits -> 32-bit POCSAG codeword (BCH parity + even parity)."""
    cw31 = (int(data21) << 10) | _bch_remainder(int(data21))
    parity = bin(cw31).count("1") & 1
    return (cw31 << 1) | parity


@lru_cache(maxsize=1)
def _syndrome_table():
    """syndrome -> 31-bit error pattern, for all 1- and 2-bit errors."""
    table = {}
    for i in range(31):
        e1 = 1 << i
        table[_syndrome31(e1)] = e1
        for j in range(i + 1, 31):
            e2 = e1 | (1 << j)
            table[_syndrome31(e2)] = e2
    return table


def _syndrome31(cw31: int) -> int:
    r = cw31
    for d in range(30, 9, -1):
        if r >> d & 1:
            r ^= BCH_GEN << (d - 10)
    return r & 0x3FF


def bch3121_syndrome_decode(cw32: int):
    """32-bit codeword -> (data21, ok) correcting up to 2 bit errors.

    A zero syndrome is trusted directly (a wrong parity bit alone does not
    affect the data).  When a correction was applied, the overall even
    parity must agree afterwards: that catches the 3-error patterns the
    bare 2-error syndrome table would silently miscorrect.
    """
    cw31 = int(cw32) >> 1
    syn = _syndrome31(cw31)
    if syn == 0:
        return (cw31 >> 10) & 0x1FFFFF, True
    e = _syndrome_table().get(syn)
    if e is None:
        return (cw31 >> 10) & 0x1FFFFF, False
    cw31 ^= e
    parity_ok = (bin(cw31).count("1") + (int(cw32) & 1)) % 2 == 0
    return (cw31 >> 10) & 0x1FFFFF, parity_ok


def _words_to_bits(words) -> np.ndarray:
    w = np.asarray([int(v) for v in words], np.uint64)
    shifts = np.arange(31, -1, -1, dtype=np.uint64)
    return ((w[:, None] >> shifts) & np.uint64(1)).astype(np.int8).reshape(-1)


def _bits_to_words(bits) -> list:
    """(32 k,) bits, MSB first -> k ints."""
    b = np.asarray(bits, np.int64).reshape(-1, 32)
    return [int(v) for v in b @ (np.int64(1) << np.arange(31, -1, -1))]


def pocsag_encode(address: int, message: str = "", function: int = 0
                  ) -> np.ndarray:
    """One POCSAG transmission (preamble + one batch) as int8 bits.

    The address codeword sits in the frame slot ``address & 7``; message
    codewords (7-bit ASCII packed 20 bits a codeword) follow immediately.
    """
    if not 0 <= int(address) <= (1 << 21) - 1:
        raise ValueError("POCSAG address must fit in 21 bits (<= 2097151)")
    frame_slot = int(address) & 7
    # 21 data bits of an address codeword: [0 | addr18 | func2]
    addr_data = ((int(address) >> 3) & ((1 << 18) - 1)) << 2 \
        | (int(function) & 3)
    msg_bits = []
    for ch in message:
        c = ord(ch) & 0x7F
        msg_bits.extend((c >> i) & 1 for i in range(7))   # LSB-first
    while msg_bits and len(msg_bits) % 20:
        msg_bits.append(0)
    msg_words = [int("".join(map(str, msg_bits[i: i + 20])), 2)
                 for i in range(0, len(msg_bits), 20)]

    slots = [IDLE_WORD] * 16
    pos = 2 * frame_slot
    slots[pos] = bch3121_encode(addr_data)               # address: bit0=0
    capacity = 16 - (pos + 1)
    if len(msg_words) > capacity:
        raise ValueError(
            f"message needs {len(msg_words)} codewords but frame slot "
            f"{frame_slot} leaves {capacity} in one batch "
            f"(max {capacity * 20 // 7} characters for this address)")
    k = pos + 1
    for mw in msg_words:
        slots[k] = bch3121_encode((1 << 20) | mw)        # message: bit0=1
        k += 1
    preamble = np.tile([1, 0], 288).astype(np.int8)
    return np.concatenate([preamble,
                           _words_to_bits([SYNC_WORD] + slots)])


def pocsag_transmit(address: int, message: str = "", sps: int = 8,
                    separation: float = 0.1) -> np.ndarray:
    """Bits -> CPFSK baseband (bit 0 = +deviation tone per POCSAG), host
    complex64 numpy as in the JAX package; the phase accumulates in
    float64 (a float32 running phase drifts by ~1e-5 rad over a batch)."""
    bits = pocsag_encode(address, message)
    syms = torch.from_numpy((1 - bits).astype(np.int32))   # 0 -> high tone
    iq, _ = fsk.fsk_modulate(syms, sps, 2, separation, dtype=torch.float64)
    return iq.to(torch.complex64).numpy()


def pocsag_decode_bits(bits) -> list:
    """Bit stream -> list of decoded pages
    dict(address, function, message, n_codewords_ok)."""
    b = np.asarray(bits, np.int8)
    sync = _words_to_bits([SYNC_WORD])
    if len(b) < 17 * 32:
        return []
    w = np.lib.stride_tricks.sliding_window_view(b, 32)
    hits = np.nonzero((w == sync).all(axis=1))[0]
    pages = []
    for h in hits:
        frame = b[h + 32: h + 32 + 16 * 32]
        if len(frame) < 16 * 32:
            continue
        words = _bits_to_words(frame)
        addr = None
        func = 0
        msg_bits = []
        n_ok = 0
        for i, cw in enumerate(words):
            if cw == IDLE_WORD:
                continue
            data, ok = bch3121_syndrome_decode(cw)
            n_ok += ok
            if data >> 20 & 1:                           # message codeword
                if addr is not None:
                    msg_bits.extend((data >> (19 - j)) & 1
                                    for j in range(20))
            else:
                addr = (data >> 2) << 3 | (i // 2)
                func = data & 3
        if addr is None:
            continue
        chars = []
        for i in range(0, len(msg_bits) - 6, 7):
            c = sum(msg_bits[i + j] << j for j in range(7))
            if c:
                chars.append(chr(c))
        pages.append({"address": addr, "function": func,
                      "message": "".join(chars), "n_codewords_ok": n_ok})
    return pages


def pocsag_receive(iq, sps: int = 8, separation: float = 0.1) -> list:
    """Complex baseband -> decoded pages: the FSK discriminator where
    ``iq`` lies (numpy on the CPU) over its whole symbols, one copy of the
    symbols to the host, then the framing."""
    x = torch.as_tensor(iq).to(torch.complex64)
    T = (x.shape[-1] // sps) * sps
    syms, _ = fsk.fsk_demod_discriminator(
        fm_demod_init(torch.complex64, device=x.device), x[..., :T], sps, 2,
        separation)
    bits = 1 - syms.cpu().numpy()
    return pocsag_decode_bits(bits.astype(np.int8))
