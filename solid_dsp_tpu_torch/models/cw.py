"""CW (Morse code) keyer and decoder.

Port of ``solid_dsp_tpu/models/cw.py``.  The decoder's per-sample work
(the envelope and its moving average, through ``conv1d_mxu``) runs where
the input lies; the adaptive threshold, the run lengths, the blind dit
estimate and the ratio classification work on the short sequence of
on/off runs on the host in numpy, as in the JAX package (:93-129), after
one read-back of the envelope.  The keyer builds its gate on the host
(:65) and returns the keyed tone on ``device`` (the card by default).
The Morse table is the port's own copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_constant, resolve_device
from ..ops.fir import conv1d_mxu

__all__ = ["MORSE", "cw_keyer", "cw_decode", "text_to_morse"]

MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".",
    "F": "..-.", "G": "--.", "H": "....", "I": "..", "J": ".---",
    "K": "-.-", "L": ".-..", "M": "--", "N": "-.", "O": "---",
    "P": ".--.", "Q": "--.-", "R": ".-.", "S": "...", "T": "-",
    "U": "..-", "V": "...-", "W": ".--", "X": "-..-", "Y": "-.--",
    "Z": "--..",
    "0": "-----", "1": ".----", "2": "..---", "3": "...--", "4": "....-",
    "5": ".....", "6": "-....", "7": "--...", "8": "---..", "9": "----.",
    ".": ".-.-.-", ",": "--..--", "?": "..--..", "/": "-..-.",
    "=": "-...-", "+": ".-.-.",
}
_INV = {v: k for k, v in MORSE.items()}


def text_to_morse(text: str) -> str:
    """Text -> dots and dashes, ' ' between letters, ' / ' between
    words."""
    return " / ".join(" ".join(MORSE[c] for c in w if c in MORSE)
                      for w in text.upper().split())


def cw_keyer(text: str, dit_samples: int = 64, freq: float = 0.1,
             amp: float = 1.0, device=None) -> torch.Tensor:
    """A keyed complex tone (complex64 on ``device``) with the standard
    spacing: a dit 1 unit on, a dah 3; 1 off between elements, 3 between
    letters, 7 between words."""
    if dit_samples < 4:
        raise ValueError("dit_samples must be >= 4")
    on = []
    for word in text.upper().split():
        for letter in word:
            code = MORSE.get(letter)
            if code is None:
                continue
            for sym in code:
                on += [1] * ((1 if sym == "." else 3) * dit_samples)
                on += [0] * dit_samples
            on += [0] * (2 * dit_samples)        # 1 + 2 = 3 dits
        on += [0] * (4 * dit_samples)            # 3 + 4 = 7 dits
    gate = np.asarray(on[:-4 * dit_samples] if on else on, np.float32)
    tone = np.exp(2j * np.pi * freq * np.arange(len(gate))).astype(
        np.complex64)
    return torch.from_numpy(amp * gate * tone).to(resolve_device(device))


def cw_decode(x, dit_samples: int | None = None, smooth: int = 9) -> str:
    """Decode a CW waveform (complex baseband or real audio) to text:
    envelope, moving average, a threshold midway between the on and off
    levels, run lengths, the dit period estimated blindly (the smallest
    cluster of marks and interior gaps; ``dit_samples`` overrides it), and
    ratio classification (tolerant of +-30 % keying jitter).  For real
    audio make ``smooth`` at least one carrier period."""
    x = torch.as_tensor(x)
    env = torch.abs(x).to(torch.float32)
    if smooth > 1:
        k = device_constant(np.full(smooth, 1.0 / smooth, np.float32),
                            env.device)
        env = conv1d_mxu(torch.cat([env, env.new_zeros(smooth - 1)]), k)
    e = env.cpu().numpy()
    if not e.size or float(e.max()) <= 0.0:
        return ""
    hi = float(np.percentile(e, 95))
    lo = float(np.percentile(e, 5))
    if hi - lo < 0.25 * hi:                   # no keying present
        return ""
    # keyed CW has a duty below ~55 %: the 35th percentile sits on the off
    # floor; a noise-only envelope is unimodal and is squelched
    if hi < 2.0 * float(np.percentile(e, 35)):
        return ""
    gate = e > 0.5 * (hi + lo)
    edges = np.flatnonzero(np.diff(gate.astype(np.int8)))
    bounds = np.r_[0, edges + 1, len(gate)]
    runs = [(bool(gate[a]), b - a) for a, b in zip(bounds, bounds[1:])]
    if not any(on for on, _ in runs):
        return ""
    if dit_samples:
        dit = float(dit_samples)
    else:
        # marks and interior gaps above the smoothing span (shorter runs
        # are noise crossings); at least one mark must survive
        floor = 2.0 * smooth + 4.0
        good_marks = [r for on_, r in runs if on_ and r > floor]
        if not good_marks:
            return ""
        gaps = [r for i, (on_, r) in enumerate(runs)
                if not on_ and 0 < i < len(runs) - 1 and r > floor]
        durs = np.asarray(good_marks + gaps, float)
        dit = float(np.median(durs[durs <= 2.0 * durs.min()]))
    out = []
    letter = ""
    for i, (on, r) in enumerate(runs):
        u = r / dit
        if on:
            letter += "." if u < 2.0 else "-"
        elif 0 < i < len(runs) - 1:
            if u >= 4.5:                       # word gap (7 dits, -30 %)
                out += [_INV.get(letter, "?"), " "]
                letter = ""
            elif u >= 2.0:                     # letter gap (3 dits)
                out.append(_INV.get(letter, "?"))
                letter = ""
    if letter:
        out.append(_INV.get(letter, "?"))
    return "".join(out).strip()
