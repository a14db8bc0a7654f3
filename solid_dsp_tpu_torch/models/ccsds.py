"""CCSDS-style concatenated coding: RS(255,223) outer + K=7 conv inner.

Port of ``solid_dsp_tpu/models/ccsds.py`` (CCSDS 131.0-B): the rate-1/2
(171,133) convolutional inner code, a byte interleaver across I RS
codewords, the RS(255,223) outer code.  Encoding runs on the device (RS
parity as a GF(2) product, the convolutional encoder); decoding runs the
soft Viterbi walk on the device (S7 on the card, ``models/fec.py``), reads
the bits back once and decodes RS (syndromes on the device, the locator on
the host for the codewords that need it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import bind_device
from . import fec
from .rs import rs_255_223

__all__ = ["CCSDSLink"]


class CCSDSLink:
    """Byte-in / byte-out concatenated codec on ``device`` (the card unless
    told otherwise); ``interleave``: RS codewords a frame (CCSDS allows
    1..8)."""

    def __init__(self, interleave: int = 4, device=None):
        if interleave < 1:
            raise ValueError("interleave depth must be >= 1")
        self.I = int(interleave)
        self.device = bind_device(device)
        self.rs = rs_255_223(self.device)
        self.payload_bytes = self.rs.k * self.I

    def encode(self, data: bytes) -> torch.Tensor:
        """payload (223 I bytes) -> channel bits ((255 I 8 + 6) 2, int32)."""
        buf = np.frombuffer(bytes(data), np.uint8)
        if len(buf) != self.payload_bytes:
            raise ValueError(
                f"payload must be exactly {self.payload_bytes} bytes")
        cws = self.rs.encode(torch.from_numpy(
            buf.reshape(self.I, self.rs.k).astype(np.int32)))
        inter = cws.T.reshape(-1)                       # (I * 255,)
        sh = torch.arange(7, -1, -1, device=self.device, dtype=torch.int32)
        bits = ((inter[:, None] >> sh) & 1).reshape(-1)
        return fec.conv_encode(bits)

    def decode(self, llrs) -> tuple:
        """Channel LLRs (positive favours bit 0) -> (payload bytes, ok).
        Hard channel bits also work (pass 1 - 2 bits as the LLRs)."""
        bits = fec.viterbi_decode(torch.as_tensor(llrs).to(self.device),
                                  soft=True).cpu().numpy()
        n_bytes = self.I * self.rs.n
        if len(bits) != n_bytes * 8:
            raise ValueError(
                f"expected {n_bytes * 8} decoded bits, got {len(bits)}")
        by = np.packbits(bits.astype(np.uint8)).astype(np.int32)
        deinter = by.reshape(self.rs.n, self.I).T       # (I, 255)
        msg, ok = self.rs.decode(deinter)
        return (msg.cpu().numpy().astype(np.uint8).reshape(-1).tobytes(),
                bool(ok.all()))

    def __repr__(self):
        return f"CCSDSLink [RS(255,223) x{self.I}] [conv K=7 r=1/2]"
