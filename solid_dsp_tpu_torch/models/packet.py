"""PacketModem: the framed digital link in one object.

Port of ``solid_dsp_tpu/models/packet.py``:

    TX: bytes -> CRC-32 tail -> additive scramble -> FEC -> block
        interleave -> Gray map (M-PSK/M-QAM) -> RRC pulse shape
        -> [ZC, ZC] preamble + payload burst
    RX: normalised preamble correlation (FrameSync) -> Moose CFO and common
        phase correction -> RRC matched filter -> pilot-aided phase
        tracking -> max-log LLRs -> deinterleave -> soft decode
        -> descramble -> CRC check

Every ``fec_scheme`` of the JAX package: ``conv`` (the K = 7 soft Viterbi,
S7 on the card), ``ldpc``, ``polar``, ``turbo`` (S6 on the card) and the
hard-decision ``block_codes.SCHEMES``.  Known QPSK pilots every
``pilot_every`` symbol slots: the phase at each pilot is unwrapped and
interpolated across the data symbols (``linear_mod.unwrap`` / ``interp``).
The frame layout (preamble, pilot positions, interleaver dimensions) is
the JAX package's, built on the host; the burst runs on ``device`` (the
card unless told otherwise).  The decoded bits come back to the host once
a burst for the CRC, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device, device_constant
from ..utils import bits as B
from ..utils import sequences as seq
from . import block_codes
from . import fec
from . import framesync as fs
from . import ldpc as ldpc_mod
from . import linear_mod as lm

__all__ = ["PacketModem"]


def _interleaver_dims(n: int) -> tuple:
    """Most-square (rows, cols) factorisation; (1, n) if prime."""
    best = (1, n)
    for r in range(2, int(np.sqrt(n)) + 1):
        if n % r == 0:
            best = (r, n // r)
    return best


def crc_tail_ok(plain: np.ndarray) -> tuple:
    """(payload bits, CRC ok) of descrambled host bits whose last 32 are
    the LSB-first CRC-32 of the rest."""
    payload_bits, crc_bits = plain[:-32], plain[-32:]
    got = B.crc32(payload_bits.astype(np.int8))
    sent = int(np.sum(np.left_shift(crc_bits.astype(np.uint64),
                                    np.arange(32, dtype=np.uint64))))
    return payload_bits, got == sent


def framed_bits(data: bytes, payload_bytes: int) -> np.ndarray:
    """payload bits (MSB first) + their LSB-first CRC-32, scrambled (host)."""
    if len(data) != payload_bytes:
        raise ValueError(f"payload must be exactly {payload_bytes} bytes")
    info = B._bytes_to_bits_msb_first(data)
    c = B.crc32(info.astype(np.int8))
    tail = ((c >> np.arange(32)) & 1).astype(np.int8)
    framed = torch.from_numpy(np.concatenate([info, tail]).astype(np.int32))
    return B.additive_scramble(framed).numpy()


class PacketModem:
    """Fixed-size framed packet link over an M-PSK/M-QAM burst, on
    ``device`` (the card unless told otherwise)."""

    def __init__(self, payload_bytes: int = 64, scheme: str = "psk",
                 m: int = 4, sps: int = 4, preamble_len: int = 127,
                 preamble_root: int = 5, rolloff: float = 0.35,
                 delay_symbols: int = 6, threshold: float = 0.4,
                 fec_scheme: str = "conv", ldpc_iters: int = 30,
                 polar_iters: int = 40, turbo_iters: int = 8,
                 pilot_every: int = 16, dtype=torch.complex64, device=None):
        soft_schemes = ("conv", "ldpc", "polar", "turbo")
        if fec_scheme not in soft_schemes and \
                fec_scheme not in block_codes.SCHEMES:
            raise ValueError(
                f"unknown fec_scheme {fec_scheme!r}; one of "
                f"{list(soft_schemes) + list(block_codes.SCHEMES)}")
        dev = self.device = bind_device(device)
        self.payload_bytes = int(payload_bytes)
        self.fec_scheme = fec_scheme
        self.ldpc_iters = int(ldpc_iters)
        self.modem = lm.LinearModem(scheme, m, sps, delay_symbols, rolloff,
                                    dtype, dev)
        self.n_info = 8 * self.payload_bytes + 32          # + CRC-32
        if fec_scheme == "conv":
            self.code = fec.ConvCode(device=dev)
            self.n_coded = (self.n_info + self.code.K - 1) * 2
            self.ileave = _interleaver_dims(self.n_coded)
        elif fec_scheme in block_codes.SCHEMES:
            self.code = block_codes.BlockCode(fec_scheme, dev)
            self.n_frames = -(-self.n_info // self.code.k)
            self.n_coded = self.n_frames * self.code.n
            self.ileave = _interleaver_dims(self.n_coded)
        elif fec_scheme == "turbo":
            from . import turbo as turbo_mod
            self.code = turbo_mod.TurboCode(self.n_info,
                                            n_iter=int(turbo_iters),
                                            device=dev)
            self.n_coded = self.code.n_coded
            self.ileave = (1, self.n_coded)
        else:
            if fec_scheme == "ldpc":
                self.code = ldpc_mod.wifi_ldpc_648(dev)
            else:
                from . import polar as polar_mod
                self.code = polar_mod.PolarCode(256, 128,
                                                n_iters=int(polar_iters),
                                                device=dev)
            self.n_frames = -(-self.n_info // self.code.k)
            self.n_coded = self.n_frames * self.code.n
            self.ileave = (1, self.n_coded)
        k = self.modem.k
        self.n_pad = (-self.n_coded) % k
        self.n_data_symbols = (self.n_coded + self.n_pad) // k
        # slot i is a pilot iff i % pilot_every == 0 (0 disables)
        self.pilot_every = int(pilot_every)
        if self.pilot_every:
            if self.pilot_every < 2:
                raise ValueError("pilot_every must be >= 2 (or 0)")
            T = self.n_data_symbols
            while T - (-(-T // self.pilot_every)) < self.n_data_symbols:
                T += 1
            self.n_symbols = T
            self.pilot_pos = np.arange(0, T, self.pilot_every)
            mask = np.zeros(T, bool)
            mask[self.pilot_pos] = True
            self.data_pos = np.nonzero(~mask)[0]
            pb = seq.m_sequence(10, seed=0x155)[: 2 * len(self.pilot_pos)]
            ps = lm.bits_to_symbols(pb.astype(np.int32), 2).numpy()
            self.pilot_syms = lm.psk_constellation(4)[ps][
                : len(self.pilot_pos)]
        else:
            self.n_symbols = self.n_data_symbols
            self.pilot_pos = np.zeros(0, np.int64)
            self.data_pos = np.arange(self.n_symbols)
            self.pilot_syms = np.zeros(0, complex)
        self.flush = 2 * delay_symbols * sps
        self.payload_samples = self.n_symbols * sps + self.flush
        p = seq.zadoff_chu(preamble_root, preamble_len)
        self.sync = fs.FrameSync(p, self.payload_samples, threshold, dev)
        self.frame_samples = 2 * preamble_len + self.payload_samples
        self.dtype = dtype

    # ------------------------------------------------------------- TX

    def _encode_bits(self, data: bytes) -> torch.Tensor:
        scrambled = torch.from_numpy(
            framed_bits(data, self.payload_bytes)).to(self.device)
        r, cdim = self.ileave
        if self.fec_scheme in ("ldpc", "polar"):
            padded = scrambled.new_zeros(self.n_frames * self.code.k)
            padded[: self.n_info] = scrambled
            return self.code.encode(padded.reshape(
                self.n_frames, self.code.k)).reshape(-1)
        if self.fec_scheme in block_codes.SCHEMES:
            padded = scrambled.new_zeros(self.n_frames * self.code.k)
            padded[: self.n_info] = scrambled
            return fec.interleave(self.code.encode(padded), r, cdim)
        return fec.interleave(self.code.encode(scrambled), r, cdim)

    def transmit(self, data: bytes) -> torch.Tensor:
        """bytes -> one burst of ``frame_samples`` IQ samples."""
        bits = self._encode_bits(data).to(torch.int32)
        bits = torch.cat([bits, bits.new_zeros(self.n_pad)])
        data_iq = lm.modulate_symbols(lm.bits_to_symbols(bits, self.modem.k),
                                      self.modem.points)
        iq = torch.zeros(self.n_symbols, dtype=data_iq.dtype,
                         device=self.device)
        iq[device_constant(self.data_pos, self.device, torch.long)] = data_iq
        if self.pilot_every:
            iq[device_constant(self.pilot_pos, self.device, torch.long)] = \
                torch.from_numpy(self.pilot_syms).to(self.device, iq.dtype)
        # flush=True shapes 2 delay_symbols zero symbols after the payload
        shaped = lm.pulse_shape(iq.to(self.dtype), self.modem.sps,
                                self.modem.delay_symbols, self.modem.rolloff,
                                self.dtype, flush=True)
        pp = torch.from_numpy(self.sync.full_preamble()).to(self.device,
                                                            self.dtype)
        return torch.cat([pp, shaped])

    # ------------------------------------------------------------- RX

    def receive(self, x):
        """IQ containing one burst -> (bytes, info dict): FrameSync's
        telemetry and ``crc_ok``; on a CRC failure the bytes are the
        best-effort decode."""
        x = torch.as_tensor(x).to(self.device, self.dtype)
        payload, info = self.sync.extract(x)
        y_sym = self.modem._symbol_estimates(payload)
        if self.pilot_every:
            y_sym = self._pilot_phase_correct(y_sym)
        y_data = y_sym[device_constant(self.data_pos, self.device,
                                       torch.long)]
        llr = lm.demap_soft(y_data, self.modem.points,
                            self._noise_var(y_data))[: self.n_coded]
        r, cdim = self.ileave
        if self.fec_scheme in ("ldpc", "polar"):
            iters = (self.ldpc_iters if self.fec_scheme == "ldpc"
                     else self.code.n_iters)
            dec, _ok = self.code.decode(
                llr.reshape(self.n_frames, self.code.n), n_iters=iters)
            dec = dec.reshape(-1)[: self.n_info]
        elif self.fec_scheme in block_codes.SCHEMES:
            hard = (fec.deinterleave(llr, r, cdim) < 0).to(torch.int32)
            dec, _fail = self.code.decode(hard)
            dec = dec[: self.n_info]
        elif self.fec_scheme == "turbo":
            dec, _llr = self.code.decode(llr)
            dec = dec[: self.n_info]
        else:
            dec = self.code.decode(fec.deinterleave(llr, r, cdim),
                                   soft=True)[: self.n_info]
        plain = B.additive_scramble(dec).cpu().numpy()
        payload_bits, ok = crc_tail_ok(plain)
        out = dict(info)
        out["crc_ok"] = bool(ok) and bool(info["found"])
        return np.packbits(payload_bits.astype(np.uint8)).tobytes(), out

    def _noise_var(self, y_sym):
        c = torch.as_tensor(self.modem.points, device=y_sym.device).to(
            y_sym.dtype)
        r = y_sym - c[lm.slice_symbols(y_sym, self.modem.points).long()]
        return torch.mean((r * torch.conj(r)).real) + 1e-12

    def _pilot_phase_correct(self, y_sym):
        """De-rotate by the pilot-measured phase trajectory: the phase at
        each pilot, unwrapped and interpolated across every slot (flat past
        the ends)."""
        dev = y_sym.device
        pil = torch.from_numpy(self.pilot_syms).to(dev, y_sym.dtype)
        ph = lm.unwrap(torch.angle(
            y_sym[device_constant(self.pilot_pos, dev, torch.long)]
            * torch.conj(pil)))
        traj = lm.interp(
            torch.arange(self.n_symbols, dtype=ph.dtype, device=dev),
            device_constant(self.pilot_pos, dev, ph.dtype), ph)
        return y_sym * torch.exp(-1j * traj).to(y_sym.dtype)

    # ------------------------------------------------------- RX stream

    def receive_stream(self, x, max_bursts: int = 64) -> list:
        """Decode every burst of a long capture: one normalised preamble
        correlation over the stream on the device, host peak-picking
        (``framesync.scan_bursts``), each burst decoded on its own slice.
        Returns [(bytes, info)] with ``info["offset"]`` the slice's start."""
        x = torch.as_tensor(x).to(self.device, self.dtype)
        pp = torch.from_numpy(self.sync.full_preamble()).to(self.device,
                                                            self.dtype)
        rho2, _ = fs.preamble_correlate(x, pp)
        return fs.scan_bursts(
            (rho2 > self.sync.threshold).cpu().numpy(), self.frame_samples,
            2 * self.sync.L, int(x.shape[-1]),
            lambda lo, hi: self.receive(x[lo:hi]), max_bursts)
