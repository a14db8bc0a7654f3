"""RDS (Radio Data System): the 57 kHz data subcarrier on broadcast FM.

Port of ``solid_dsp_tpu/models/rds.py``.  RDS rides at 3x the 19 kHz
pilot, BPSK DSB-SC at 1187.5 bps (= 57000/48), biphase (Manchester)
symbols, differential data coding.  The block code is a (26, 16) cyclic
code: 16 info bits + a 10-bit checkword XORed with a per-position offset
word (A, B, C, C', D) that gives block sync with no extra framing bits
(IEC 62106).

Checkword and syndrome arithmetic, group encode/parse and the modulator
are host work with the JAX package's results (``rds_modulate`` returns
host numpy).  The receiver runs where the MPX lies: the 19 kHz pilot by a
complex mix and a centred lowpass, the 57 kHz carrier as the unit pilot
phasor cubed (formed u*u*u), coherent demodulation, and the biphase
matched filter at every offset with the per-offset mean |score| in
float64 (as JAX's host ``np.convolve`` and means: a float32 reduction
could pick another offset where two means are close), keeping the first
maximum.  The oscillators are exact wrapped phases: n f / fs reduced
modulo 1 in integer arithmetic on the device where f / fs is a small
rational (19 kHz / 456 kHz = 1/24), else built in float64 on the host.
Block sync takes the syndromes of every 26-bit window at once (the
syndrome is linear over GF(2)), then walks JAX's greedy rule: a hit
takes four blocks and jumps 104 bits.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..design import firdes
from .fm import _filt_same

__all__ = ["rds_checkword", "rds_syndrome", "OFFSET_WORDS",
           "encode_group", "make_ps_groups", "rds_modulate",
           "rds_demodulate_bits", "block_sync_decode", "parse_groups",
           "rds_receive"]

RDS_GEN = 0b10110111001        # g(x) = x^10+x^8+x^7+x^5+x^4+x^3+1
BITRATE_DIV = 48               # bit rate = 57 kHz / 48 = 1187.5 bps
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350,
                "D": 0x1B4}
_OFFSET_SEQ = ("A", "B", "C", "D")


def _poly_rem(value: int, top_deg: int) -> int:
    r = int(value)
    for d in range(top_deg, 9, -1):
        if r >> d & 1:
            r ^= RDS_GEN << (d - 10)
    return r & 0x3FF


def rds_checkword(info16: int, offset: str) -> int:
    """10-bit checkword: rem(info * x^10) XOR the block's offset word."""
    return _poly_rem(int(info16) << 10, 25) ^ OFFSET_WORDS[offset]


def rds_syndrome(block26: int, offset: str) -> int:
    """Zero iff the 26-bit block is valid under the given offset word."""
    return _poly_rem(int(block26) ^ OFFSET_WORDS[offset], 25)


def encode_group(infos) -> np.ndarray:
    """Four 16-bit info words -> 104 group bits (offsets A, B, C, D)."""
    bits = []
    for info, off in zip(infos, _OFFSET_SEQ):
        block = (int(info) << 10) | rds_checkword(info, off)
        bits.extend((block >> (25 - i)) & 1 for i in range(26))
    return np.asarray(bits, np.int8)


def make_ps_groups(pi: int, ps_name: str) -> np.ndarray:
    """Type-0A groups carrying an 8-character programme-service name."""
    ps = f"{ps_name:<8.8s}"
    bits = []
    for seg in range(4):
        a = int(pi) & 0xFFFF
        b = (0 << 12) | (0 << 11) | (1 << 10) | (0 << 2) | seg  # 0A, TP=0
        c = 0x0000                                               # AF: none
        d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        bits.append(encode_group([a, b, c, d]))
    return np.concatenate(bits)


def rds_modulate(bits, fs: float, phase_pilot: float = 0.0) -> np.ndarray:
    """Data bits -> MPX-rate RDS signal (float32 host numpy; add it to the
    stereo multiplex).

    Differential encode, biphase (+half/-half) symbol shaping, DSB-SC on
    sin(3 * pilot phase), the receiver's pilot-cubed reference.  ``fs``
    must give an even integer number of samples per 1187.5 Hz bit (any
    multiple of 228 kHz works).
    """
    spb = fs / 1187.5
    if abs(spb - round(spb)) > 1e-9:
        raise ValueError("fs must be an integer multiple of 1187.5 Hz")
    spb = int(round(spb))
    if spb % 2:
        raise ValueError("samples per bit must be even (biphase halves)")
    b = np.asarray(bits, np.int8)
    diff = np.bitwise_xor.accumulate(b) if len(b) else b   # differential
    lvl = 1.0 - 2.0 * diff.astype(np.float64)  # bit -> +-1
    half = spb // 2
    sym = np.repeat(lvl, spb)
    sign = np.tile(np.r_[np.ones(half), -np.ones(half)], len(b))
    base = sym * sign
    n = np.arange(len(base))
    # the subcarrier is the pilot's third harmonic IN PHASE: sin(3 theta)
    # (a cos-phased carrier lands in the receiver's quadrature arm)
    carrier = np.sin(2.0 * np.pi * (57000.0 / fs) * n + 3.0 * phase_pilot)
    return (base * carrier).astype(np.float32)


def _oscillator(n: int, freq: float, fs: float, sign: float, device
                ) -> torch.Tensor:
    """exp(sign 2 pi j freq k / fs), k < n, complex64 on ``device``: the
    float64 oscillator rounded once.  (freq k / fs) mod 1 is formed
    exactly in int64 on the device where freq / fs = p / q is a rational
    with p (n - 1) below 2^62, else in float64 on the host."""
    r = Fraction(float(freq)) / Fraction(float(fs))
    p, q = r.numerator, r.denominator
    if n and p * (n - 1) < 1 << 62:
        k = torch.arange(n, dtype=torch.int64, device=device)
        cyc = torch.remainder(k * p, q).to(torch.float64) / q
    else:
        cyc = torch.from_numpy((float(r) * np.arange(n)) % 1.0).to(device)
    return torch.exp((sign * 2.0 * np.pi * 1j) * cyc).to(torch.complex64)


def rds_demodulate_bits(mpx, fs: float) -> np.ndarray:
    """MPX -> hard data bits (host int8): carrier from pilot^3, coherent
    BPSK, biphase integrate + best bit-phase search, differential decode;
    computed where ``mpx`` lies (numpy on the CPU)."""
    x = torch.as_tensor(mpx).to(torch.float32)
    n = x.shape[-1]
    dev = x.device
    # pilot extraction (as in fm_stereo_decode): complex 19k mix + LPF
    lp = firdes.firdes_kaiser(301, 2000.0 / fs, 60.0, 0.0)
    pz = _filt_same(x.to(torch.complex64)
                    * _oscillator(n, 19000.0, fs, -1.0, dev),
                    lp.astype(np.complex64))
    u = pz / torch.clamp(torch.abs(pz), min=1e-20)   # unit pilot phasor
    # 57 kHz carrier = (pilot phasor)^3 * e^{j 3 w19 n}; demod = x * carr*
    carr = (u * u * u) * _oscillator(n, 57000.0, fs, 1.0, dev)
    bb = _filt_same((x * 2.0).to(torch.complex64) * torch.conj(carr),
                    firdes.firdes_kaiser(301, 2400.0 / fs, 60.0,
                                         0.0).astype(np.complex64))
    d = torch.real(bb)
    spb = int(round(fs / 1187.5))
    half = spb // 2
    nbits = n // spb
    if nbits < 1:
        return np.zeros(0, np.int8)
    # biphase matched filter at EVERY offset (zero-padded tail, as JAX's
    # np.convolve): mf[k] = sum d[k:k+half] - sum d[k+half:k+spb], as
    # differences of one float64 running sum
    c = torch.cumsum(torch.cat([torch.zeros(1, dtype=torch.float64,
                                            device=dev),
                                d.to(torch.float64),
                                torch.zeros(spb, dtype=torch.float64,
                                            device=dev)]), 0)
    k = nbits * spb
    mf = 2.0 * c[half:half + k] - c[:k] - c[spb:spb + k]
    scores = mf.reshape(nbits, spb)           # column off: offset off's
    means = torch.mean(torch.abs(scores), dim=0).cpu().numpy()
    off = int(np.argmax(means))               # the first maximum
    lvl = (scores[:, off] < 0).to(torch.int8).cpu().numpy()
    bits = lvl ^ np.concatenate([[0], lvl[:-1]]).astype(np.int8)
    return bits.astype(np.int8)


def _block_rems() -> np.ndarray:
    """rem(x^(25 - j)) for each bit j of a 26-bit block, MSB first: a
    block's remainder is the XOR of its set bits' rows."""
    return np.asarray([_poly_rem(1 << (25 - j), 25) for j in range(26)],
                      np.int32)


def block_sync_decode(bits) -> list:
    """Slide over the bit stream; a position where four consecutive
    26-bit blocks have zero syndrome under offsets A,B,C,D is a group,
    after which the walk jumps 104 bits (JAX's greedy rule)."""
    b = np.asarray(bits, np.int8).astype(np.int32)
    nmax = len(b) - 104
    if nmax < 0:
        return []
    nw = len(b) - 25                           # 26-bit windows
    rem = np.zeros(nw, np.int32)
    for j, r in enumerate(_block_rems()):
        rem ^= b[j:j + nw] * r
    hit = np.ones(nmax + 1, bool)
    for k, off in enumerate(_OFFSET_SEQ):
        hit &= rem[26 * k: 26 * k + nmax + 1] == OFFSET_WORDS[off]
    weights = 1 << np.arange(15, -1, -1)
    groups = []
    nxt = 0
    for i in np.nonzero(hit)[0]:
        if i < nxt:
            continue
        groups.append([int(b[i + 26 * k: i + 26 * k + 16] @ weights)
                       for k in range(4)])
        nxt = i + 104
    return groups


def parse_groups(groups) -> dict:
    """Extract PI and PS name from type-0 groups."""
    out = {"pi": None, "ps": [" "] * 8}
    for a, bword, _c, dword in groups:
        out["pi"] = a
        gtype = bword >> 12
        if gtype == 0:
            seg = bword & 3
            out["ps"][2 * seg] = chr((dword >> 8) & 0x7F)
            out["ps"][2 * seg + 1] = chr(dword & 0x7F)
    out["ps"] = "".join(out["ps"]).rstrip()
    return out


def rds_receive(mpx, fs: float) -> dict:
    """MPX -> dict(pi, ps, n_groups).  block_sync_decode slides bit by
    bit, so it already covers every bit/biphase alignment."""
    groups = block_sync_decode(rds_demodulate_bits(mpx, fs))
    info = parse_groups(groups) if groups else {"pi": None, "ps": ""}
    info["n_groups"] = len(groups)
    return info
