"""OFDMModem: the byte-in / byte-out multicarrier packet link.

Port of ``solid_dsp_tpu/models/ofdm_link.py``, the multicarrier sibling of
``models/packet.py``:

    TX: bytes -> CRC-32 -> scramble -> conv FEC -> interleave -> Gray
        M-QAM/M-PSK map -> comb pilots -> OFDM symbols (IFFT + CP)
        -> [Schmidl-Cox preamble | full-pilot symbol | data symbols]
    RX: S&C timing + fractional CFO -> derotate -> FFT grid -> LS channel
        estimate from the full-pilot symbol -> one-tap EQ -> per-symbol
        common phase from the comb pilots -> max-log LLRs -> deinterleave
        -> soft Viterbi (S7 on the card) -> descramble -> CRC check

``fec_scheme`` ``conv`` or ``ldpc``, as in JAX.  The frame layout (pilot
positions and values, reference symbol, preamble, interleaver) is the JAX
package's, built on the host; the burst runs on ``device`` (the card unless
told otherwise).  The sync position comes back to the host once a burst
(JAX rolls by a traced start), and the decoded bits once for the CRC.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device, device_constant
from ..utils import bits as B
from ..utils import sequences as seq
from . import fec
from . import linear_mod as lm
from . import ofdm
from . import ofdm_pilots as op
from .packet import crc_tail_ok, framed_bits

__all__ = ["OFDMModem"]


class OFDMModem:
    """Fixed-size framed packet link over an OFDM burst, on ``device`` (the
    card unless told otherwise)."""

    def __init__(self, payload_bytes: int = 64, nfft: int = 64,
                 cp: int = 16, n_active: int = 48, scheme: str = "qam",
                 m: int = 16, pilot_spacing: int = 6,
                 fec_scheme: str = "conv", ldpc_iters: int = 30,
                 dtype=torch.complex64, device=None):
        if fec_scheme not in ("conv", "ldpc"):
            raise ValueError(f"unknown fec_scheme {fec_scheme!r}")
        dev = self.device = bind_device(device)
        self.payload_bytes = int(payload_bytes)
        self.nfft, self.cp, self.n_active = int(nfft), int(cp), int(n_active)
        self.dtype = dtype
        self.points = np.asarray(lm.constellation(scheme, m))
        self.k = int(np.log2(m))
        self.n_info = 8 * self.payload_bytes + 32
        self.fec_scheme = fec_scheme
        self.ldpc_iters = int(ldpc_iters)
        if fec_scheme == "ldpc":
            from . import ldpc as ldpc_mod
            self.code = ldpc_mod.wifi_ldpc_648(dev)
            self.n_frames = -(-self.n_info // self.code.k)
            self.n_coded = self.n_frames * self.code.n
            self.ileave = (1, self.n_coded)
        else:
            self.code = fec.ConvCode(device=dev)
            self.n_coded = (self.n_info + self.code.K - 1) * 2
            r = int(np.sqrt(self.n_coded))
            while self.n_coded % r:
                r -= 1
            self.ileave = (r, self.n_coded // r)
        coords = op.active_carrier_coords(nfft, n_active)
        self.pilot_idx, self.data_idx = op.comb_pilot_indices(
            n_active, pilot_spacing, coords=coords)
        self.pilots = op.pilot_values(len(self.pilot_idx))
        per_sym = len(self.data_idx)
        self.n_pad_bits = (-self.n_coded) % self.k
        n_data_syms = (self.n_coded + self.n_pad_bits) // self.k
        self.n_ofdm = -(-n_data_syms // per_sym)
        self.n_fill = self.n_ofdm * per_sym - n_data_syms
        self.n_data_syms = n_data_syms
        pb = seq.m_sequence(11, seed=0x71)[: 2 * n_active]
        ps = lm.bits_to_symbols(pb.astype(np.int32), 2).numpy()
        self.ref_syms = lm.psk_constellation(4)[ps][:n_active]
        self.preamble = ofdm.schmidl_cox_preamble(nfft, cp)
        sym_len = nfft + cp
        self.frame_samples = (len(self.preamble)
                              + (1 + self.n_ofdm) * sym_len)

    def _const(self, a) -> torch.Tensor:
        return device_constant(np.asarray(a).astype(np.complex64),
                               self.device)

    # ------------------------------------------------------------- TX

    def _encode_bits(self, data: bytes) -> torch.Tensor:
        scrambled = torch.from_numpy(
            framed_bits(data, self.payload_bytes)).to(self.device)
        if self.fec_scheme == "ldpc":
            padded = scrambled.new_zeros(self.n_frames * self.code.k)
            padded[: self.n_info] = scrambled
            return self.code.encode(padded.reshape(
                self.n_frames, self.code.k)).reshape(-1)
        return fec.interleave(self.code.encode(scrambled), *self.ileave)

    def transmit(self, data: bytes) -> torch.Tensor:
        """bytes -> one OFDM burst of ``frame_samples`` IQ samples."""
        bits = self._encode_bits(data).to(torch.int32)
        bits = torch.cat([bits, bits.new_zeros(self.n_pad_bits)])
        syms = lm.modulate_symbols(lm.bits_to_symbols(bits, self.k),
                                   self.points)
        fill = torch.from_numpy(self.ref_syms[: self.n_fill]).to(
            self.device, syms.dtype)
        grid_data = torch.cat([syms, fill]).reshape(self.n_ofdm,
                                                    len(self.data_idx))
        grid = op.insert_pilots(grid_data.to(self.dtype),
                                self._const(self.pilots), self.pilot_idx,
                                self.data_idx, self.n_active)
        ref = torch.from_numpy(self.ref_syms).to(self.device, self.dtype)
        body = ofdm.ofdm_modulate(torch.cat([ref[None, :], grid]), self.nfft,
                                  self.cp, self.n_active)
        return torch.cat([self._const(self.preamble).to(self.dtype),
                          body.to(self.dtype)])

    # ------------------------------------------------------------- RX

    def receive(self, x):
        """IQ containing one burst -> (bytes, info dict of sync position,
        CFO, SNR estimate and ``crc_ok``)."""
        x = torch.as_tensor(x).to(self.device, self.dtype)
        start, cfo = ofdm.schmidl_cox_sync(x, self.nfft, self.cp)
        n = x.shape[-1]
        derot = x * torch.exp(-2j * np.pi * cfo * torch.arange(
            n, device=self.device)).to(self.dtype)
        sym_len = self.nfft + self.cp
        start_h = int(start)
        frame0 = start_h + self.nfft - self.cp // 2
        need = (1 + self.n_ofdm) * sym_len
        seg = torch.roll(derot, -frame0)[:need]
        Y = ofdm.ofdm_demodulate(seg, self.nfft, self.cp, self.n_active)
        H = ofdm.estimate_channel(Y[0], self._const(self.ref_syms).to(
            self.dtype))
        Z = ofdm.equalize(Y[1:], H)
        pil = self._const(self.pilots).to(self.dtype)
        pidx = device_constant(self.pilot_idx.astype(np.int64), self.device,
                               torch.long)
        rot = torch.sum(Z[:, pidx] * torch.conj(pil)[None, :], -1)
        rot = rot / torch.clamp(torch.abs(rot), min=1e-12)
        Z = Z * torch.conj(rot)[:, None]
        res = Z[:, pidx] - pil[None, :]
        nv = torch.mean((res * torch.conj(res)).real) + 1e-9
        y_data = Z[:, device_constant(self.data_idx.astype(np.int64),
                                      self.device, torch.long)].reshape(-1)
        y_data = y_data[: self.n_data_syms]
        llr = lm.demap_soft(y_data, self.points.astype(np.complex64),
                            nv)[: self.n_coded]
        if self.fec_scheme == "ldpc":
            dec, _ok = self.code.decode(
                llr.reshape(self.n_frames, self.code.n),
                n_iters=self.ldpc_iters)
            dec = dec.reshape(-1)[: self.n_info]
        else:
            dec = self.code.decode(fec.deinterleave(llr, *self.ileave),
                                   soft=True)[: self.n_info]
        plain = B.additive_scramble(dec).cpu().numpy()
        payload_bits, ok = crc_tail_ok(plain)
        info = {
            "start": start_h,
            "cfo": float(cfo),
            "snr_db": float(10 * np.log10(1.0 / float(nv))),
            "crc_ok": bool(ok),
        }
        return np.packbits(payload_bits.astype(np.uint8)).tobytes(), info

    def __repr__(self):
        return (f"OFDMModem [nfft={self.nfft}] [cp={self.cp}] "
                f"[active={self.n_active}] [M={len(self.points)}] "
                f"[{self.n_ofdm} symbols/frame]")

    # ------------------------------------------------------- RX stream

    def receive_stream(self, x, threshold: float = 0.5,
                       max_bursts: int = 64) -> list:
        """Decode every burst of a long capture: one Schmidl-Cox metric pass
        on the device, host peak-picking (``framesync.scan_bursts``), each
        burst decoded on its own slice."""
        from . import framesync as fs

        x = torch.as_tensor(x).to(self.device, self.dtype)
        M, _ = ofdm.schmidl_cox_metric(x, self.nfft)
        return fs.scan_bursts(
            (M > threshold).cpu().numpy(), self.frame_samples,
            len(self.preamble), int(x.shape[-1]),
            lambda lo, hi: self.receive(x[lo:hi]), max_bursts)
