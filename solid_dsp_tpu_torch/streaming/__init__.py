"""Streaming: the chain's carried state and its checkpoints, the
overlap-save framing the filters share, the reference's ring buffer and
window, and chain composition (as in the JAX package, ``compose`` here is
the function; its module is ``streaming.compose`` for imports)."""

from . import framing, ring, state, window  # noqa: F401
from .compose import Stage, compose, stream_scan  # noqa: F401
from .ring import BufferError, CircularBuffer  # noqa: F401
from .state import ChainState  # noqa: F401
from .window import Window  # noqa: F401
