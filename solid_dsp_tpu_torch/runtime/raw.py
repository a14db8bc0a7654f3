"""Raw ci16 ingest: a recording's interleaved int16 blocks on the device.

A ci16 recording is the native capture format of most SDR front ends.  The
native runtime's :class:`~solid_dsp_tpu_torch.runtime.StreamPump` converts
it to complex64 on the host (8 bytes a sample to copy); this reader keeps
the int16 (4 bytes a sample) all the way to the DDC kernels, which convert
in registers (``ops/ddc.py``), so the two routes give the same bits.

:class:`Ci16Reader` is a Python thread that fills a small ring of host
buffers with ``readinto`` (a file read releases the GIL, so the thread reads
the next block while the consumer computes; a thread needs no native source
of the port's own, and ``native/solid_runtime.cc`` has only converting
pumps).  For a CUDA device the buffers are pinned, and each block goes to
the card with ``non_blocking=True`` on a side stream; the consumer's stream
waits for the copy's event, and the reader waits for the same event before
it reads into that buffer again.  On the CPU the same route runs without
pinning, a buffer handed back when the consumer asks for the next block.

Blocks are ``block`` samples, (n, 2) int16, short at the end of the
recording; a trailing partial sample is dropped, as the pump drops it.
"""

from __future__ import annotations

import queue
import threading

import torch

__all__ = ["Ci16Reader"]

_SAMPLE_BYTES = 4                  # int16 I and Q
_DEPTH = 3                         # host buffers: read, in flight, in use


class Ci16Reader:
    """Blocks of a ci16 recording (``path``; ``/dev/stdin`` reads a pipe)
    as (n, 2) int16 tensors on ``device``::

        with Ci16Reader(path, block=1 << 20, device="cuda") as reader:
            for x in reader:            # (n, 2) int16 on the card
                out = chain.execute_block(x)

    Three host buffers of ``block`` samples rotate between the reader
    thread and the copies."""

    def __init__(self, path: str, block: int = 1 << 20, device="cuda"):
        self.block = int(block)
        if self.block <= 0:
            raise ValueError("block must be a positive number of samples")
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._file = open(path, "rb", buffering=0)
        self._bufs = [torch.empty((self.block, 2), dtype=torch.int16,
                                  pin_memory=cuda) for _ in range(_DEPTH)]
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._free: queue.Queue = queue.Queue()     # (slot, event or None)
        self._full: queue.Queue = queue.Queue()     # (slot, samples)
        for i in range(_DEPTH):
            self._free.put((i, None))
        self._held = None            # CPU: the slot the consumer holds
        self._done = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # reader thread ------------------------------------------------------

    def _run(self):
        try:
            while True:
                slot, event = self._free.get()
                if slot is None:                     # closed
                    return
                if event is not None:                # its copy is done
                    event.synchronize()
                n = self._fill(self._bufs[slot])
                if n:
                    self._full.put((slot, n))
                if n < self.block:
                    self._full.put((None, 0))        # the end
                    return
        except BaseException as e:                   # handed to the consumer
            self._full.put((None, e))

    def _fill(self, buf: torch.Tensor) -> int:
        """Whole samples read into buf: the buffer full, or to the end."""
        view = memoryview(buf.numpy()).cast("B")
        got = 0
        while got < len(view):
            r = self._file.readinto(view[got:])
            if not r:
                break
            got += r
        return got // _SAMPLE_BYTES

    # consumer -------------------------------------------------------------

    def _take(self):
        """Blocking: (slot, samples) of the next filled buffer, (None, 0) at
        the end, (None, error) if the reader failed: the consumer's wait."""
        return self._full.get()

    def next_block(self) -> torch.Tensor | None:
        """The next block, (n, 2) int16 on the device (n < ``block`` only at
        the end); None when the recording is done."""
        if self._held is not None:                   # CPU: its block is used
            self._free.put((self._held, None))
            self._held = None
        if self._done:
            return None
        slot, n = self._take()
        if slot is None:
            self._done = True
            if isinstance(n, BaseException):
                raise n
            return None
        host = self._bufs[slot][:n]
        if self._stream is None:
            self._held = slot
            return host
        with torch.cuda.stream(self._stream):
            x = host.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(copied)
        x.record_stream(consumer)
        self._free.put((slot, copied))
        return x

    def __iter__(self):
        while True:
            x = self.next_block()
            if x is None:
                return
            yield x

    def close(self):
        """Stop the reader thread and close the file."""
        self._free.put((None, None))
        self._thread.join(timeout=5.0)
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
