"""Reed-Solomon over GF(256): the byte-oriented outer code.

Port of ``solid_dsp_tpu/models/rs.py``: the CCSDS/DVB outer code.  GF(256)
addition is XOR and multiplication by a constant is linear over GF(2), so
systematic parity and the syndromes are binary matrices acting on the
bytes' bit-planes (the JAX package's host tables, copied here), each one
product mod 2 on the device, batched over codewords.  The products run as
float32 matmuls under ``device.fp32_exact`` (``utils/bits.py::gf2_matmul``;
a sum is of at most 2040 ones, exact): ``torch.matmul`` has no int32 kernel
on the card.  The error locator (Berlekamp-Massey, Chien, Forney, with
erasures) stays on the host in numpy, as in JAX, and runs only for the
codewords whose syndrome is nonzero: one read-back a batch.

Presets: RS(255, 223) (t = 16, primitive poly 0x11D) and RS(204, 188) (DVB:
t = 8, shortened from RS(255, 239) by 51).  :class:`RSCode` holds a device
(the card unless told otherwise); ``encode`` and ``decode`` return tensors
there.
"""

from __future__ import annotations

import functools
from functools import lru_cache

import numpy as np
import torch

from ..device import bind_device, device_constant
from ..utils.bits import gf2_matmul

__all__ = ["RSCode", "rs_255_223", "rs_204_188"]

_PRIM_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1


@lru_cache(maxsize=1)
def _gf_tables():
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM_POLY
    exp[255:510] = exp[:255]
    return exp, log


def _gf_mul(a, b):
    exp, log = _gf_tables()
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    out = exp[(log[a] + log[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _gf_div(a, b):
    exp, log = _gf_tables()
    if np.any(b == 0):
        raise ZeroDivisionError("GF division by zero")
    return np.where(a == 0, 0, exp[(log[a] - log[b]) % 255])


def _gf_poly_mul(p, q):
    out = np.zeros(len(p) + len(q) - 1, np.int32)
    for i, c in enumerate(p):
        out[i: i + len(q)] ^= _gf_mul(c, q)
    return out


def _gf_poly_eval(poly, x):
    """Horner evaluate poly (highest degree first) at scalar/array x."""
    y = np.zeros_like(np.asarray(x), np.int32) + poly[0]
    for c in poly[1:]:
        y = _gf_mul(y, x) ^ c
    return y


@lru_cache(maxsize=4)
def _generator_poly(nroots: int) -> tuple:
    """g(x) = prod_{j=1..2t} (x - alpha^j), highest degree first."""
    exp, _ = _gf_tables()
    g = np.array([1], np.int32)
    for j in range(1, nroots + 1):
        g = _gf_poly_mul(g, np.array([1, exp[j]], np.int32))
    return tuple(int(c) for c in g)


def _bits(x, width=8):
    """(..., B) bytes -> (..., B*8) bits, MSB first per byte."""
    x = np.asarray(x, np.int32)
    return ((x[..., None] >> np.arange(width - 1, -1, -1)) & 1).reshape(
        *x.shape[:-1], -1)


@lru_cache(maxsize=8)
def _parity_matrix_bits(k: int, nroots: int):
    """Binary (nroots*8, k*8) map: message bit-planes -> parity bits, the
    JAX package's table: the systematic encoder's LFSR (parity = msg x^2t
    mod g) run for every unit message at once."""
    g = np.asarray(_generator_poly(nroots), np.int32)[1:]
    cols = np.arange(k * 8)
    msgs = np.zeros((k * 8, k), np.int32)
    msgs[cols, cols // 8] = 1 << (7 - cols % 8)     # column i*8 + (7 - b)
    par = np.zeros((k * 8, nroots), np.int32)
    for i in range(k):
        fb = msgs[:, i] ^ par[:, 0]
        par = np.concatenate([par[:, 1:], np.zeros((k * 8, 1), np.int32)],
                             axis=1)
        par ^= _gf_mul(fb[:, None], g[None, :])
    return _bits(par).T.astype(np.int8)


@lru_cache(maxsize=8)
def _syndrome_matrix_bits(n: int, nroots: int):
    """Binary (nroots*8, n*8) map: received bit-planes -> syndromes, with
    r_0 the LAST codeword byte: column i*8 + (7 - b) holds the bits of
    (2^b) alpha^(deg j), deg = n - 1 - i, j = 1 .. nroots."""
    exp, _ = _gf_tables()
    deg = (n - 1 - np.arange(n))[:, None, None]
    j = np.arange(1, nroots + 1)[None, None, :]
    r = (1 << np.arange(8))[None, :, None]
    s = _gf_mul(np.broadcast_to(r, (n, 8, nroots)), exp[(deg * j) % 255])
    M = np.zeros((nroots * 8, n * 8), np.int8)
    for b in range(8):
        M[:, np.arange(n) * 8 + (7 - b)] = _bits(s[:, b]).T
    return M


def _byte_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., B) bytes -> (..., B*8) bits, MSB first (on x's device)."""
    sh = device_constant(np.arange(7, -1, -1, dtype=np.int32), x.device)
    return ((x[..., None] >> sh) & 1).reshape(*x.shape[:-1], -1)


def _bit_bytes(b: torch.Tensor, nbytes: int) -> torch.Tensor:
    sh = device_constant(np.arange(7, -1, -1, dtype=np.int32), b.device)
    return torch.sum(b.reshape(*b.shape[:-1], nbytes, 8) << sh, -1,
                     dtype=torch.int32)


class RSCode:
    """RS(255-shorten, 255-nroots-shorten) with t = nroots/2 correction;
    ``shorten`` leading message bytes are implicitly zero.  On ``device``
    (the card unless told otherwise)."""

    def __init__(self, nroots: int = 32, shorten: int = 0, device=None):
        if nroots < 2 or nroots % 2 or nroots >= 255:
            raise ValueError("nroots must be even, in [2, 254]")
        if not 0 <= shorten < 255 - nroots:
            raise ValueError(f"shorten must be in [0, {255 - nroots})")
        self.nroots = int(nroots)
        self.t = self.nroots // 2
        self.n = 255 - shorten
        self.k = 255 - self.nroots - shorten
        self.shorten = shorten
        self.device = bind_device(device)

    @functools.cached_property
    def _parity_t(self) -> torch.Tensor:
        """(k*8, nroots*8) float32 on the device: the parity map, the
        shortened leading bytes' columns dropped."""
        M = _parity_matrix_bits(255 - self.nroots, self.nroots)
        return torch.from_numpy(M[:, self.shorten * 8:].T.astype(
            np.float32)).to(self.device)

    @functools.cached_property
    def _syndrome_t(self) -> torch.Tensor:
        S = _syndrome_matrix_bits(255, self.nroots)
        return torch.from_numpy(S[:, self.shorten * 8:].T.astype(
            np.float32)).to(self.device)

    def encode(self, msg) -> torch.Tensor:
        """(..., k) message bytes -> (..., n) systematic codewords (int32):
        one binary product mod 2 over the message bit-planes."""
        msg = torch.as_tensor(msg).to(self.device, torch.int32)
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} message bytes")
        pbits = gf2_matmul(_byte_bits(msg), self._parity_t)
        return torch.cat([msg, _bit_bytes(pbits, self.nroots)], -1)

    def syndromes(self, rx) -> torch.Tensor:
        """(..., n) received bytes -> (..., 2t) syndromes (int32)."""
        rx = torch.as_tensor(rx).to(self.device, torch.int32)
        sbits = gf2_matmul(_byte_bits(rx), self._syndrome_t)
        return _bit_bytes(sbits, self.nroots)

    def _correct_one(self, rx: np.ndarray, synd: np.ndarray,
                     era_degs: tuple = ()):
        """Berlekamp-Massey + Chien + Forney for ONE nonzero-syndrome
        codeword, with erasures at Chien degrees ``era_degs`` (deg = n - 1 -
        index): nu errors and mu erasures while 2 nu + mu <= 2t.  Returns
        (corrected bytes, ok).  The JAX package's host code."""
        exp, _ = _gf_tables()
        nroots = self.nroots
        mu = len(era_degs)
        if mu > nroots:
            return rx, False
        Lam = np.zeros(nroots + 1, np.int32)
        Lam[0] = 1
        for deg in era_degs:
            X = int(exp[int(deg) % 255])
            shifted = np.roll(Lam, 1)
            shifted[0] = 0
            Lam = Lam ^ _gf_mul(X, shifted)
        Bpoly = Lam.copy()
        L = mu
        for r in range(mu + 1, nroots + 1):
            d = 0
            for i in range(0, min(r, nroots + 1)):
                if r - 1 - i >= 0 and Lam[i]:
                    d ^= _gf_mul(int(Lam[i]), int(synd[r - 1 - i]))
            d = int(d)
            Bs = np.roll(Bpoly, 1)
            Bs[0] = 0
            if d == 0:
                Bpoly = Bs
            else:
                T = Lam ^ _gf_mul(d, Bs)
                if 2 * L <= r + mu - 1:
                    L = r + mu - L
                    Bpoly = _gf_mul(_gf_div(1, d), Lam)
                else:
                    Bpoly = Bs
                Lam = T
        n_loc = L
        if 2 * n_loc - mu > nroots:
            return rx, False
        degs = np.arange(self.n)
        Xinv = exp[(255 - degs) % 255]
        lam_hi = Lam[: n_loc + 1][::-1]
        vals = _gf_poly_eval(lam_hi, Xinv)
        err_deg = degs[vals == 0]
        if len(err_deg) != n_loc:
            return rx, False
        Sp = np.zeros(nroots, np.int32)
        Sp[:] = synd
        Om = np.zeros(nroots, np.int32)
        for i in range(min(n_loc, nroots - 1) + 1):
            Om[i:] ^= _gf_mul(int(Lam[i]), Sp[: nroots - i])
        out = rx.copy()
        for deg in err_deg:
            xinv = exp[(255 - int(deg)) % 255]
            num = _gf_poly_eval(Om[:nroots][::-1], xinv)
            den = 0
            for i in range(1, n_loc + 1, 2):
                den ^= _gf_mul(Lam[i], exp[((i - 1) * (255 - int(deg)))
                                           % 255])
            if den == 0:
                return rx, False
            out[self.n - 1 - deg] ^= int(_gf_div(int(num), int(den)))
        return out, True

    def decode(self, rx, erasures=None):
        """(..., n) received bytes -> (msg (..., k) int32, ok (...,) bool),
        tensors on the code's device.  ``erasures``: an optional (..., n)
        boolean mask of known-unreliable bytes (errors-and-erasures
        decoding).  The syndromes are one product on the device, read back
        once; only codewords with a nonzero syndrome go to the host
        locator."""
        host = (rx.detach().cpu().numpy() if isinstance(rx, torch.Tensor)
                else np.asarray(rx))
        host = host.astype(np.int32)
        flat = host.reshape(-1, self.n)
        synd = self.syndromes(torch.from_numpy(flat)).cpu().numpy()
        era = None
        if erasures is not None:
            era = (erasures.detach().cpu().numpy()
                   if isinstance(erasures, torch.Tensor)
                   else np.asarray(erasures)).astype(bool).reshape(-1, self.n)
            if era.shape != flat.shape:
                raise ValueError("erasure mask must match rx shape")
        ok = np.ones(len(flat), bool)
        out = flat.copy()
        for i in np.nonzero(synd.any(axis=-1))[0]:
            degs = ()
            if era is not None:
                degs = tuple(self.n - 1 - np.nonzero(era[i])[0])
            out[i], ok[i] = self._correct_one(flat[i], synd[i], degs)
        msg = out[:, : self.k].reshape(host.shape[:-1] + (self.k,))
        return (torch.from_numpy(msg).to(self.device),
                torch.from_numpy(ok.reshape(host.shape[:-1])).to(self.device))

    def __repr__(self):
        return f"RSCode [n={self.n}] [k={self.k}] [t={self.t}]"


def rs_255_223(device=None) -> RSCode:
    return RSCode(nroots=32, device=device)


def rs_204_188(device=None) -> RSCode:
    return RSCode(nroots=16, shorten=51, device=device)
