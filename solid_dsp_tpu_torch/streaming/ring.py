"""Host-side circular buffer (stream staging between IO and device blocks).

Port of ``solid_dsp_tpu/streaming/ring.py``, the reference's
``src/circular_buffer/mod.rs`` in Python: new (:79), push (:433-447), append
(:469-494), pop (:512-524), release (:548-557), linearize (:220-238), to_vec
(:261), reset (:289), len/capacity/is_empty/is_full (:313-375) and the error
codes (:27-33).  A host utility (the reference exports it, and its DSP paths
never use it); on-device streaming state lives in ChainState, and the C++
ring of the same semantics is ``runtime.CircularBuffer``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CircularBuffer", "BufferError", "BufferErrorCode"]


class BufferErrorCode:
    """Reference BufferErrorCode parity (circular_buffer/mod.rs:27-33)."""

    FULL = "full"                    # FullBuffer
    EMPTY = "empty"                  # EmptyBuffer
    NOT_ENOUGH = "not_enough"        # NotEnoughBuffer
    NEGATIVE = "negative"            # NegativeBuffer
    TOO_MANY_ELEMENTS = NOT_ENOUGH   # legacy alias (pre-r4 name)


class BufferError(RuntimeError):
    def __init__(self, code: str):
        super().__init__(f"Buffer Error: {code}")
        self.code = code


class CircularBuffer:
    """Fixed-capacity FIFO ring over a NumPy array."""

    def __init__(self, capacity: int, dtype=np.complex128):
        if capacity <= 0:
            raise ValueError("capacity must be > 0")
        self._buf = np.zeros(int(capacity), dtype=dtype)
        self._capacity = int(capacity)
        self._read = 0
        self._len = 0

    @classmethod
    def from_vec(cls, values, dtype=None) -> "CircularBuffer":
        values = np.asarray(values)
        cb = cls(len(values), dtype or values.dtype)
        cb.append(values)
        return cb

    # introspection ------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    def capacity(self) -> int:
        return self._capacity

    def reserved(self) -> int:
        return self._capacity - self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def is_full(self) -> bool:
        return self._len == self._capacity

    def read_index(self) -> int:
        return self._read

    def write_index(self) -> int:
        return (self._read + self._len) % self._capacity

    # mutation -------------------------------------------------------------
    def push(self, element) -> None:
        """Append one element; BufferError(FULL) when at capacity."""
        if self.is_full():
            raise BufferError(BufferErrorCode.FULL)
        self._buf[self.write_index()] = element
        self._len += 1

    def append(self, other) -> None:
        """Append a block; BufferError(NOT_ENOUGH) if it won't fit
        (reference append :469-494 returns NotEnoughBuffer)."""
        other = np.asarray(other)
        n = len(other)
        if n > self.reserved():
            raise BufferError(BufferErrorCode.NOT_ENOUGH)
        w = self.write_index()
        first = min(n, self._capacity - w)
        self._buf[w : w + first] = other[:first]
        if n > first:
            self._buf[: n - first] = other[first:]
        self._len += n

    def pop(self):
        """Remove and return the oldest element; BufferError(EMPTY) if empty."""
        if self.is_empty():
            raise BufferError(BufferErrorCode.EMPTY)
        v = self._buf[self._read]
        self._read = (self._read + 1) % self._capacity
        self._len -= 1
        return v

    def release(self, n: int) -> None:
        """Drop the oldest n elements.

        Reference release (:548-557): n < 0 -> NegativeBuffer,
        n > len -> NotEnoughBuffer.
        """
        if n < 0:
            raise BufferError(BufferErrorCode.NEGATIVE)
        if n > self._len:
            raise BufferError(BufferErrorCode.NOT_ENOUGH)
        self._read = (self._read + n) % self._capacity
        self._len -= n

    def linearize(self) -> None:
        """Rotate storage so the read index is 0 (contiguous view)."""
        self._buf = np.roll(self._buf, -self._read)
        self._read = 0

    def __getitem__(self, i):
        """RAW storage indexing — the reference Derefs to the underlying
        slice (circular_buffer/mod.rs:595-609), so ``buffer[0]`` is storage
        slot 0, not the oldest element, until ``linearize()`` is called.
        Kept for doctest parity; use ``to_vec()`` for logical order."""
        return self._buf[i]

    def to_vec(self) -> np.ndarray:
        """Contents oldest-first as a contiguous array."""
        idx = (self._read + np.arange(self._len)) % self._capacity
        return self._buf[idx].copy()

    def reset(self) -> None:
        self._read = 0
        self._len = 0
        self._buf[:] = 0

    def __repr__(self) -> str:
        return (
            f"CircularBuffer<{self._buf.dtype}> [Capacity={self._capacity}] "
            f"[Len={self._len}]"
        )
