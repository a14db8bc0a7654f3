"""Host-side and bit-level utilities: the synchronisation and spreading
sequences (``sequences``: Zadoff-Chu, m-sequences, Gold codes, a numpy copy
of the JAX package's ``utils/sequences.py``), the GF(2) scramblers and
CRCs (``bits``), and the observability layer: timers, benchmarking, trace
capture and roofline counters (``profiling``) and per-block stream metrics
(``metrics``)."""

from .profiling import Timer, benchmark, trace, emit_metric  # noqa: F401
from .metrics import BlockMetrics, MetricsCollector, rssi_db  # noqa: F401
from . import bits, sequences  # noqa: F401
