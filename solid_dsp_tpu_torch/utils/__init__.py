"""Host-side utilities: the synchronisation and spreading sequences
(``sequences``: Zadoff-Chu, m-sequences, Gold codes), a numpy copy of the
JAX package's ``utils/sequences.py``."""

from . import sequences  # noqa: F401
