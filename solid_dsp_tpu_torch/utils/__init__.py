"""Host-side and bit-level utilities: the synchronisation and spreading
sequences (``sequences``: Zadoff-Chu, m-sequences, Gold codes, a numpy copy
of the JAX package's ``utils/sequences.py``) and the GF(2) scramblers and
CRCs (``bits``)."""

from . import bits, sequences  # noqa: F401
