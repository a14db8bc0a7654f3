"""Native (C++) runtime: ring buffer, IQ files, threaded block pipeline and
live network sources.

Port of ``solid_dsp_tpu/runtime/__init__.py`` over the same C++ source and
C interface (``native/solid_runtime.cc``, built by :mod:`.build` into the
port's own library at first use):

* :class:`CircularBuffer`: the reference's ring (push/append/pop/release,
  linearized read, over/underflow errors) as a lock-free C++ SPSC ring sized
  in samples of any numpy dtype;
* :func:`read_iq` / :func:`write_iq`: IQ recordings in the common SDR
  interleaved formats (``IQ_FORMATS``: cf32, ci16, ci8, cf64, cu8),
  converted to complex64 in native code;
* :class:`StreamPump`: a C++ reader thread that prefetches and converts file
  blocks into the ring while the consumer computes;
* :class:`UdpSource`, :class:`TcpSource`, :class:`RtlTcpSource`: live IQ
  over UDP datagrams, a raw TCP stream, or an ``rtl_tcp`` server (its
  12-byte ``RTL0`` greeting and 5-byte command channel);
* SigMF recordings (:mod:`.sigmf`).

These are host objects: every block is numpy complex64, and the consumer
moves it to its device (``RxChain.execute_block`` copies it there).
"""

from __future__ import annotations

import ctypes as C
import functools
import os

import numpy as np

from .build import ensure_built

__all__ = [
    "CircularBuffer", "BufferError_", "StreamPump", "UdpSource",
    "TcpSource", "RtlTcpSource", "read_iq", "write_iq",
    "IQ_FORMATS",
]

IQ_FORMATS = {"cf32": 0, "ci16": 1, "ci8": 2, "cf64": 3, "cu8": 4}

_P, _S, _L, _I = C.c_void_p, C.c_size_t, C.c_long, C.c_int
_SIGNATURES = {                     # name: (restype, argtypes)
    "sdsp_ring_create": (_P, [_S]),
    "sdsp_ring_destroy": (None, [_P]),
    "sdsp_ring_capacity": (_S, [_P]),
    "sdsp_ring_size": (_S, [_P]),
    "sdsp_ring_space": (_S, [_P]),
    "sdsp_ring_push": (_S, [_P, _P, _S]),
    "sdsp_ring_pop": (_S, [_P, _P, _S]),
    "sdsp_ring_peek": (_S, [_P, _P, _S]),
    "sdsp_ring_release": (_S, [_P, _S]),
    "sdsp_ring_reset": (None, [_P]),
    "sdsp_iq_sample_bytes": (_I, [_I]),
    "sdsp_iq_read": (_L, [C.c_char_p, _I, _L, _L, _P]),
    "sdsp_iq_write": (_L, [C.c_char_p, _I, _P, _L, _I]),
    "sdsp_pump_create": (_P, [C.c_char_p, _I, _S]),
    "sdsp_pump_destroy": (None, [_P]),
    "sdsp_pump_next": (_L, [_P, _P, _L]),
    "sdsp_pump_eof": (_I, [_P]),
    "sdsp_udp_create": (_P, [C.c_char_p, _I, _I, _S]),
    "sdsp_udp_destroy": (None, [_P]),
    "sdsp_udp_read": (_L, [_P, _P, _L]),
    "sdsp_udp_available": (_S, [_P]),
    "sdsp_udp_dropped": (C.c_ulonglong, [_P]),
    "sdsp_tcp_create": (_P, [C.c_char_p, _I, _I, _S, _I]),
    "sdsp_tcp_destroy": (None, [_P]),
    "sdsp_tcp_read": (_L, [_P, _P, _L]),
    "sdsp_tcp_available": (_S, [_P]),
    "sdsp_tcp_dropped": (C.c_ulonglong, [_P]),
    "sdsp_tcp_eof": (_I, [_P]),
    "sdsp_tcp_tuner_type": (C.c_uint, [_P]),
    "sdsp_tcp_command": (_I, [_P, _I, C.c_uint]),
}


@functools.cache
def _lib() -> C.CDLL:
    """The runtime library, built at the first call and typed."""
    lib = C.CDLL(ensure_built())
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray) -> C.c_void_p:
    return a.ctypes.data_as(C.c_void_p)


class BufferError_(RuntimeError):
    """Over/underflow: the reference's BufferErrorCode."""


class CircularBuffer:
    """Sample ring buffer over the native SPSC ring.

    The reference's API: ``push`` (one sample, raises when full),
    ``append`` (a block, raises unless it fits whole), ``pop``,
    ``read``/``release`` (linearized view, then consume), ``reset``;
    numpy in and out.
    """

    def __init__(self, max_size: int, dtype=np.complex64):
        lib = _lib()
        self.dtype = np.dtype(dtype)
        self._lib = lib
        self._ptr = lib.sdsp_ring_create(max_size * self.dtype.itemsize)
        if not self._ptr:
            raise MemoryError("ring allocation failed")
        self._max = max_size
        # kept on the object so that __del__ works while the interpreter
        # shuts down and module globals are gone
        self._destroy = lib.sdsp_ring_destroy

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._destroy(self._ptr)
            self._ptr = None

    def __len__(self):
        return self._lib.sdsp_ring_size(self._ptr) // self.dtype.itemsize

    def is_empty(self) -> bool:
        return len(self) == 0

    def is_full(self) -> bool:
        return self.space() == 0

    def capacity(self) -> int:
        return self._max

    def space(self) -> int:
        cap_extra = (self._lib.sdsp_ring_capacity(self._ptr)
                     // self.dtype.itemsize) - self._max
        free = self._lib.sdsp_ring_space(self._ptr) // self.dtype.itemsize
        return max(free - cap_extra, 0)

    def push(self, sample) -> None:
        if self.space() < 1:
            raise BufferError_("buffer full")
        a = np.asarray([sample], dtype=self.dtype)
        self._lib.sdsp_ring_push(self._ptr, _ptr(a), a.nbytes)

    def append(self, samples) -> None:
        a = np.ascontiguousarray(samples, dtype=self.dtype)
        if self.space() < a.size:
            raise BufferError_("buffer full")
        self._lib.sdsp_ring_push(self._ptr, _ptr(a), a.nbytes)

    def pop(self):
        if len(self) == 0:
            raise BufferError_("buffer empty")
        out = np.empty(1, dtype=self.dtype)
        self._lib.sdsp_ring_pop(self._ptr, _ptr(out), out.nbytes)
        return out[0]

    def read(self, n: int | None = None) -> np.ndarray:
        """Linearized non-consuming copy of the first n samples."""
        n = len(self) if n is None else min(n, len(self))
        out = np.empty(n, dtype=self.dtype)
        self._lib.sdsp_ring_peek(self._ptr, _ptr(out), out.nbytes)
        return out

    def release(self, n: int) -> None:
        if n > len(self):
            raise BufferError_("releasing more than is committed")
        self._lib.sdsp_ring_release(self._ptr, n * self.dtype.itemsize)

    def pop_block(self, n: int) -> np.ndarray:
        if n > len(self):
            raise BufferError_("buffer empty")
        out = np.empty(n, dtype=self.dtype)
        self._lib.sdsp_ring_pop(self._ptr, _ptr(out), out.nbytes)
        return out

    def reset(self) -> None:
        self._lib.sdsp_ring_reset(self._ptr)


def _fmt_code(fmt: str) -> int:
    try:
        return IQ_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown IQ format {fmt!r}; "
                         f"one of {sorted(IQ_FORMATS)}") from None


def read_iq(path: str, fmt: str = "cf32", offset: int = 0,
            count: int = -1) -> np.ndarray:
    """Read an interleaved IQ recording -> complex64 (native conversion)."""
    code = _fmt_code(fmt)
    lib = _lib()
    if count < 0:
        sb = lib.sdsp_iq_sample_bytes(code)
        count = max(os.path.getsize(path) // sb - offset, 0)
    out = np.empty(count, dtype=np.complex64)
    got = lib.sdsp_iq_read(path.encode(), code, offset, count, _ptr(out))
    if got < 0:
        raise OSError(f"failed reading {path}")
    return out[:got]


def write_iq(path: str, samples, fmt: str = "cf32",
             append: bool = False) -> int:
    """Write complex samples as an interleaved IQ recording; returns the
    samples written."""
    code = _fmt_code(fmt)
    a = np.ascontiguousarray(samples, dtype=np.complex64)
    got = _lib().sdsp_iq_write(path.encode(), code, _ptr(a), a.size,
                               1 if append else 0)
    if got < 0:
        raise OSError(f"failed writing {path}")
    return int(got)


class _Native:
    """A native object owned by the Python one: ``close`` (also on
    ``__del__`` and leaving a ``with``) destroys it once."""

    _ptr = None

    def close(self):
        if getattr(self, "_ptr", None):
            self._destroy(self._ptr)
            self._ptr = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamPump(_Native):
    """Threaded IQ-file prefetcher: a C++ reader thread keeps a ring of
    converted complex64 samples full while Python consumes blocks::

        with StreamPump(path, fmt="ci16", block=1 << 20) as pump:
            for block in pump:          # np.complex64 arrays
                out = chain.execute_block(block)
    """

    def __init__(self, path: str, fmt: str = "cf32", block: int = 1 << 20,
                 ring_samples: int | None = None):
        code = _fmt_code(fmt)
        lib = _lib()
        self.block = int(block)
        ring_samples = ring_samples or 4 * self.block
        self._next = lib.sdsp_pump_next
        self._destroy = lib.sdsp_pump_destroy
        self._ptr = lib.sdsp_pump_create(path.encode(), code, ring_samples)
        if not self._ptr:
            raise OSError(f"cannot open {path}")

    def next_block(self) -> np.ndarray | None:
        """Blocking: the next block (a fresh complex64 array); short at
        the end of the file; None when done."""
        out = np.empty(self.block, dtype=np.complex64)
        got = self._next(self._ptr, _ptr(out), self.block)
        if got < 0:
            raise OSError("IO error in pump reader thread")
        if got == 0:
            return None
        return out[:got]

    def __iter__(self):
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b


class UdpSource(_Native):
    """Live UDP IQ receiver: the C++ thread converts datagrams (ci8, ci16,
    cf32, cf64, cu8) to complex64 into a lock-free ring, and Python drains
    blocks without blocking.  A full ring DROPS datagrams (counted by
    ``dropped``), as a live radio does: never back-pressure::

        with UdpSource(port=5000, fmt="ci16") as src:
            block = src.read(1 << 16)     # up to N samples, no blocking
    """

    def __init__(self, port: int, fmt: str = "ci16",
                 bind_addr: str = "0.0.0.0", ring_samples: int = 1 << 22):
        code = _fmt_code(fmt)
        self._lib = _lib()
        self._destroy = self._lib.sdsp_udp_destroy
        self._ptr = self._lib.sdsp_udp_create(bind_addr.encode(), int(port),
                                              code, ring_samples)
        if not self._ptr:
            raise OSError(f"cannot bind UDP {bind_addr}:{port}")

    def read(self, max_samples: int) -> np.ndarray:
        """Non-blocking: up to max_samples complex64 (possibly none)."""
        out = np.empty(max_samples, dtype=np.complex64)
        got = self._lib.sdsp_udp_read(self._ptr, _ptr(out), max_samples)
        if got < 0:
            raise OSError("IO error in UDP receiver thread")
        return out[:got]

    @property
    def available(self) -> int:
        return int(self._lib.sdsp_udp_available(self._ptr))

    @property
    def dropped(self) -> int:
        """Datagrams dropped because the ring was full."""
        return int(self._lib.sdsp_udp_dropped(self._ptr))


class TcpSource(_Native):
    """TCP-stream IQ receiver (a raw stream in any of ``IQ_FORMATS``).

    The live-source semantics of :class:`UdpSource`: the C++ reader thread
    converts the byte stream to complex64 into a lock-free ring (a partial
    sample carried across receives), and a full ring drops bytes (counted)
    rather than back-pressuring the sender.  ``eof`` turns true once the
    remote has closed AND the ring is drained.
    """

    _CREATE_RTL = 0

    def __init__(self, host: str, port: int, fmt: str = "ci16",
                 ring_samples: int = 1 << 22):
        code = _fmt_code(fmt)
        self._lib = _lib()
        self._destroy = self._lib.sdsp_tcp_destroy
        self._ptr = self._lib.sdsp_tcp_create(host.encode(), int(port), code,
                                              ring_samples, self._CREATE_RTL)
        if not self._ptr:
            raise OSError(f"cannot connect TCP {host}:{port}")

    def read(self, max_samples: int) -> np.ndarray:
        """Non-blocking: up to max_samples complex64 (possibly none)."""
        out = np.empty(max_samples, dtype=np.complex64)
        got = self._lib.sdsp_tcp_read(self._ptr, _ptr(out), max_samples)
        if got == -1:
            raise OSError("IO error in TCP receiver thread")
        if got < 0:                      # -2: orderly EOF, drained
            return out[:0]
        return out[:got]

    @property
    def available(self) -> int:
        return int(self._lib.sdsp_tcp_available(self._ptr))

    @property
    def dropped(self) -> int:
        """Bytes dropped because the ring was full."""
        return int(self._lib.sdsp_tcp_dropped(self._ptr))

    @property
    def eof(self) -> bool:
        return bool(self._lib.sdsp_tcp_eof(self._ptr))


class RtlTcpSource(TcpSource):
    """``rtl_tcp`` client, the standard SDR network protocol: connects to
    an ``rtl_tcp`` server, checks its 12-byte ``RTL0`` greeting, streams
    its u8 IQ (offset 127.5, converted to complex64 in the C++ thread) and
    sends its 5-byte big-endian commands::

        with RtlTcpSource("127.0.0.1", 1234) as sdr:
            sdr.set_center_freq(100_300_000)
            sdr.set_sample_rate(2_048_000)
            block = sdr.read(1 << 18)
    """

    _CREATE_RTL = 1

    def __init__(self, host: str, port: int = 1234,
                 ring_samples: int = 1 << 22):
        super().__init__(host, port, fmt="cu8", ring_samples=ring_samples)

    @property
    def tuner_type(self) -> int:
        return int(self._lib.sdsp_tcp_tuner_type(self._ptr))

    def command(self, cmd: int, param: int) -> None:
        if self._lib.sdsp_tcp_command(self._ptr, int(cmd),
                                      int(param) & 0xFFFFFFFF) != 0:
            raise OSError("rtl_tcp command send failed")

    def set_center_freq(self, hz: int) -> None:
        self.command(0x01, hz)

    def set_sample_rate(self, hz: int) -> None:
        self.command(0x02, hz)

    def set_gain_mode(self, manual: bool) -> None:
        self.command(0x03, 1 if manual else 0)

    def set_gain(self, tenth_db: int) -> None:
        self.command(0x04, tenth_db)

    def set_agc(self, on: bool) -> None:
        self.command(0x08, 1 if on else 0)


# SigMF sits on read_iq/write_iq and imports them from this module: bound
# last, so that the import is not circular
from .sigmf import read_sigmf, sigmf_paths, write_sigmf  # noqa: E402

__all__ += ["read_sigmf", "write_sigmf", "sigmf_paths"]
