"""GF(2) bit-stream utilities: scramblers and CRC.

Port of ``solid_dsp_tpu/utils/bits.py``.  Both are linear systems over
GF(2), built on the host from the bitwise reference recurrences (the JAX
package's matrices, copied here), then applied on the device:

* the **additive scrambler** XORs a precomputed m-sequence;
* the **multiplicative descrambler** is feed-forward shifted XORs;
* the **multiplicative scrambler** and the **CRC** fold chunks of L bits:
  state' = M_L state + C_L chunk.  JAX scans the chunks one at a time; the
  port folds them as a tree on the device instead: each chunk's
  contribution from the zero state is one batched product, and at each
  level a left run's state is multiplied by M_L^(chunks of the right run)
  and added to the right run's, log2(n / L) levels in all (the scrambler,
  which returns every output bit, takes the prefix form of the same
  doubling).  The matrix powers come from the host.  Exact.

The GF(2) products run as float32 matmuls under ``device.fp32_exact``
(every sum is of at most 2 L ones, far below 2^24) followed by mod 2:
``torch.matmul`` has no int32 kernel on the card.

Conventions: bits are int tensors of 0/1.  ``crc32`` matches
``binascii.crc32`` (IEEE reflected); ``crc16_ccitt`` is CCITT-FALSE (0x1021,
init 0xFFFF, check value 0x29B1 over "123456789").  The functions run where
their input lies (a numpy or bytes input on the CPU) and take leading axes
as a batch, where JAX takes one stream.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import device_constant, fp32_exact
from .sequences import m_sequence

__all__ = [
    "additive_scramble", "multiplicative_scramble",
    "multiplicative_descramble",
    "crc_compute", "crc32", "crc16_ccitt", "crc_check",
]


def gf2_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) mod 2 for 0/1 operands, as int32: a float32 product in full
    float32 (exact while a sum stays below 2^24), then mod 2."""
    with fp32_exact():
        return torch.remainder(a.to(torch.float32) @ b.to(torch.float32),
                               2.0).to(torch.int32)


def _gf2_pow(M: np.ndarray, e: int) -> np.ndarray:
    """M^e mod 2 on the host (e >= 0)."""
    out = np.eye(M.shape[0], dtype=np.int64)
    base = M.astype(np.int64)
    while e:
        if e & 1:
            out = out @ base % 2
        base = base @ base % 2
        e >>= 1
    return out


# ----------------------------------------------------------- scramblers

def additive_scramble(bits, nbits: int = 15, taps=None,
                      seed: int = 1) -> torch.Tensor:
    """XOR with a maximal-length sequence (synchronous scrambler),
    self-inverse.  Default register: the DVB 15-bit generator family."""
    bits = torch.as_tensor(bits).to(torch.int32)
    n = bits.shape[-1]
    ms = m_sequence(nbits, taps, seed).astype(np.int32)
    reps = -(-n // len(ms))
    return bits ^ device_constant(np.tile(ms, reps)[:n], bits.device)


def _taps_mask(taps, nbits: int) -> int:
    mask = 0
    for t in taps:
        if not 1 <= t <= nbits:
            raise ValueError(f"tap {t} outside 1..{nbits}")
        mask |= 1 << (t - 1)
    return mask


@lru_cache(maxsize=32)
def _scrambler_tables(nbits: int, mask: int, L: int):
    """(A (L, w), Bm (L, L), Mreg (w, w), Creg (w, L)) over GF(2) for a
    chunk of L bits with the packed register (w = nbits bits, bit j =
    v[n-1-j]) as the state: v_chunk = A reg + Bm b_chunk, reg' = Mreg reg +
    Creg b_chunk.  Columns are the responses to unit registers and unit
    input bits (the recurrence is linear)."""
    full = (1 << nbits) - 1

    def run(reg, b):
        v = np.zeros(L, np.int64)
        for i in range(L):
            v[i] = b[i] ^ (bin(reg & mask).count("1") & 1)
            reg = ((reg << 1) | int(v[i])) & full
        return v, reg

    def reg_bits(reg):
        return np.array([(reg >> j) & 1 for j in range(nbits)], np.int64)

    A = np.zeros((L, nbits), np.int64)
    Mreg = np.zeros((nbits, nbits), np.int64)
    zero = np.zeros(L, np.int64)
    for j in range(nbits):
        v, reg = run(1 << j, zero)
        A[:, j] = v
        Mreg[:, j] = reg_bits(reg)
    Bm = np.zeros((L, L), np.int64)
    Creg = np.zeros((nbits, L), np.int64)
    for j in range(L):
        e = np.zeros(L, np.int64)
        e[j] = 1
        v, reg = run(0, e)
        Bm[:, j] = v
        Creg[:, j] = reg_bits(reg)
    return A, Bm, Mreg, Creg


def _prefix_states(z: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """Inclusive prefix of the affine recurrence s_k = M s_{k-1} + z_k from
    s_{-1} = 0 over chunks (..., K, w), by doubling: after level j each
    entry sums its 2^(j+1) latest chunks, the older run brought forward by
    M^(2^j)."""
    dev = z.device
    K = z.shape[-2]
    s = z
    span = 1
    while span < K:
        P = device_constant(_gf2_pow(M, span).T.astype(np.float32), dev)
        shifted = torch.cat([torch.zeros_like(s[..., :span, :]),
                             s[..., :-span, :]], -2)
        s = (s + gf2_matmul(shifted, P)) % 2
        span *= 2
    return s


_SCRAMBLE_CHUNK = 32     # the CRC's chunk too


def multiplicative_scramble(bits, nbits: int = 7, taps=(7, 4),
                            state: int = 0x7F):
    """Self-synchronizing scrambler (802.11-style x^7 + x^4 + 1 default):
    v[n] = b[n] XOR v[n-t1] XOR v[n-t2] ..., the output feeding the
    register.  Returns (scrambled, final register as an int32 tensor).

    JAX walks one bit at a time; here chunks of 32 bits fold through
    the register: each chunk's register contribution from the zero state
    (one product), every chunk's starting register by the doubling prefix,
    then every output chunk v = A reg + B b at once."""
    bits = torch.as_tensor(bits).to(torch.int32)
    dev = bits.device
    mask = _taps_mask(taps, nbits)
    full = (1 << nbits) - 1
    reg0 = int(state) & full
    n = bits.shape[-1]
    lead = bits.shape[:-1]
    L = _SCRAMBLE_CHUNK
    K = -(-n // L)
    A, Bm, Mreg, Creg = _scrambler_tables(nbits, mask, L)
    # a zero tail pads the last chunk; it changes no output before it
    b = torch.cat([bits, bits.new_zeros((*lead, K * L - n))], -1).reshape(
        *lead, K, L)
    reg0_v = np.array([(reg0 >> j) & 1 for j in range(nbits)], np.int64)
    z = gf2_matmul(b, device_constant(Creg.T.astype(np.float32), dev))
    s = _prefix_states(z, Mreg)                               # (..., K, w)
    # chunk k starts from M^k reg0 + the prefix of the chunks before it
    powers = np.zeros((K, nbits), np.int64)
    if K:
        powers[0] = reg0_v
    for k in range(1, K):
        powers[k] = Mreg @ powers[k - 1] % 2
    start = torch.cat([torch.zeros_like(s[..., :1, :]), s[..., :-1, :]], -2)
    start = (start + device_constant(powers.astype(np.int32), dev)) % 2
    v = (gf2_matmul(start, device_constant(A.T.astype(np.float32), dev))
         + gf2_matmul(b, device_constant(Bm.T.astype(np.float32), dev))) % 2
    out = v.reshape(*lead, K * L)[..., :n]
    # the final register holds the last nbits outputs (the seed's bits
    # where fewer came out), newest at bit 0
    hist = torch.cat([device_constant(np.array(
        [(reg0 >> (nbits - 1 - i)) & 1 for i in range(nbits)], np.int32),
        dev).expand(*lead, nbits), out], -1)[..., -nbits:]
    weights = device_constant(
        (1 << np.arange(nbits - 1, -1, -1)).astype(np.int32), dev)
    return out, torch.sum(hist * weights, -1, dtype=torch.int32)


def multiplicative_descramble(bits, nbits: int = 7, taps=(7, 4),
                              state: int = 0x7F) -> torch.Tensor:
    """Inverse of ``multiplicative_scramble``, feed-forward:
    b[n] = v[n] XOR v[n-t1] XOR ... with v the received stream; ``state``
    seeds the v[n < 0] history."""
    v = torch.as_tensor(bits).to(torch.int32)
    st = int(state) & ((1 << nbits) - 1)
    hist = device_constant(
        np.array([(st >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                 np.int32), v.device)   # v[-nbits] .. v[-1]
    ext = torch.cat([hist.expand(*v.shape[:-1], nbits), v], -1)
    out = v
    for t in taps:
        out = out ^ ext[..., nbits - t: nbits - t + v.shape[-1]]
    return out


# ------------------------------------------------------------------ CRC

def _bit_step(state: np.ndarray, b: int, poly_vec: np.ndarray,
              reflected: bool) -> np.ndarray:
    """One-bit reference CRC update on a GF(2) state vector (LSB first)."""
    w = len(state)
    out = np.zeros(w, np.int8)
    if reflected:
        fb = state[0] ^ b
        out[: w - 1] = state[1:]
    else:
        fb = state[w - 1] ^ b
        out[1:] = state[: w - 1]
    if fb:
        out ^= poly_vec
    return out


@lru_cache(maxsize=32)
def _crc_matrices(poly: int, width: int, reflected: bool, nbits: int):
    """(M, C): state' = M state + C chunk over GF(2) for an nbits chunk;
    chunk index 0 is the first bit processed (the JAX package's tables)."""
    pv = np.array([(poly >> i) & 1 for i in range(width)], np.int8)

    def run(state, bits_):
        s = state.copy()
        for b in bits_:
            s = _bit_step(s, int(b), pv, reflected)
        return s

    zeros_bits = np.zeros(nbits, np.int8)
    M = np.zeros((width, width), np.int8)
    for j in range(width):
        e = np.zeros(width, np.int8)
        e[j] = 1
        M[:, j] = run(e, zeros_bits)
    C = np.zeros((width, nbits), np.int8)
    z = np.zeros(width, np.int8)
    for j in range(nbits):
        bits_ = np.zeros(nbits, np.int8)
        bits_[j] = 1
        C[:, j] = run(z, bits_)
    return M, C


def _tree_fold(s: torch.Tensor, M: np.ndarray) -> torch.Tensor:
    """The state after chunks (..., K, w), each from the zero state, folded
    left to right: sum_k M^(K-1-k) s_k, by pairs (a run of zero chunks
    pads K to a power of two at the front, where it adds nothing)."""
    K = s.shape[-2]
    size = 1 << max(0, (K - 1).bit_length())
    if size > K:
        s = torch.cat([torch.zeros_like(s[..., : size - K, :]), s], -2)
    span = 1
    while s.shape[-2] > 1:
        P = device_constant(_gf2_pow(M, span).T.astype(np.float32), s.device)
        left, right = s[..., 0::2, :], s[..., 1::2, :]
        s = (gf2_matmul(left, P) + right) % 2
        span *= 2
    return s[..., 0, :]


def crc_compute(bits, poly: int, width: int, init: int, xorout: int,
                reflected: bool = False, chunk: int = 32) -> torch.Tensor:
    """CRC of 0/1 bits (..., n) -> int64 checksums (...).  ``bits[..., 0]``
    is the first bit on the wire.  The chunks' contributions are one
    product, their fold a tree of log2(n / chunk) levels, then the
    remainder's step."""
    bits = torch.as_tensor(bits).to(torch.int32)
    dev = bits.device
    n = int(bits.shape[-1])
    lead = bits.shape[:-1]
    state = device_constant(np.array(
        [(init >> i) & 1 for i in range(width)], np.int32), dev).expand(
        *lead, width)
    n_full = n // chunk
    rem = n - n_full * chunk
    if n_full:
        M, C = _crc_matrices(poly, width, reflected, chunk)
        chunks = bits[..., : n_full * chunk].reshape(*lead, n_full, chunk)
        leaves = gf2_matmul(chunks, device_constant(
            C.T.astype(np.float32), dev))                 # (..., K, w)
        folded = _tree_fold(leaves, M.astype(np.int64))
        MK = device_constant(_gf2_pow(M, n_full).T.astype(np.float32), dev)
        state = (gf2_matmul(state, MK) + folded) % 2
    if rem:
        Mr, Cr = _crc_matrices(poly, width, reflected, rem)
        state = (gf2_matmul(state, device_constant(Mr.T.astype(np.float32),
                                                   dev))
                 + gf2_matmul(bits[..., n - rem:], device_constant(
                     Cr.T.astype(np.float32), dev))) % 2
    state = state ^ device_constant(np.array(
        [(xorout >> i) & 1 for i in range(width)], np.int32), dev)
    weights = device_constant(
        (np.int64(1) << np.arange(width, dtype=np.int64)), dev)
    return torch.sum(state.to(torch.int64) * weights, -1)


def _bytes_to_bits_lsb_first(data: bytes) -> np.ndarray:
    a = np.frombuffer(data, np.uint8)
    return ((a[:, None] >> np.arange(8)) & 1).astype(np.int8).reshape(-1)


def _bytes_to_bits_msb_first(data: bytes) -> np.ndarray:
    a = np.frombuffer(data, np.uint8)
    return ((a[:, None] >> np.arange(7, -1, -1)) & 1).astype(
        np.int8).reshape(-1)


def _as_bits(data, to_bits) -> torch.Tensor:
    if isinstance(data, (bytes, bytearray)):
        data = to_bits(bytes(data))
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(data.astype(np.int32))
    return torch.as_tensor(data)


def crc32(data) -> int:
    """IEEE CRC-32 (zlib/binascii convention) of bytes or a bit array."""
    v = crc_compute(_as_bits(data, _bytes_to_bits_lsb_first),
                    poly=0xEDB88320, width=32, init=0xFFFFFFFF,
                    xorout=0xFFFFFFFF, reflected=True)
    return int(v)


def crc16_ccitt(data) -> int:
    """CRC-16/CCITT-FALSE (0x1021, init 0xFFFF) of bytes or a bit array."""
    v = crc_compute(_as_bits(data, _bytes_to_bits_msb_first), poly=0x1021,
                    width=16, init=0xFFFF, xorout=0x0000, reflected=False)
    return int(v)


def crc_check(bits_with_crc, width: int = 32, **kw) -> bool:
    """Verify a frame whose last ``width`` bits are the transmitted CRC (in
    the wire bit order the preset produced); host bits."""
    bits = np.asarray(bits_with_crc)
    payload, tail = bits[:-width], bits[-width:]
    fn = kw.pop("fn", crc32 if width == 32 else crc16_ccitt)
    got = fn(payload.astype(np.int8))
    if width == 32:
        shifts = np.arange(width, dtype=np.uint64)
    else:
        shifts = np.arange(width - 1, -1, -1).astype(np.uint64)
    sent = int(np.sum(np.left_shift(tail.astype(np.uint64), shifts)))
    return got == sent
