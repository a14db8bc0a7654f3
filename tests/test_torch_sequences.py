"""Port vs JAX package: utils/sequences.py (Zadoff-Chu, m-sequences, Gold
codes), host numpy in both.  Gate: bit-equal (the port keeps its own copy
of the module; none of it is computed on a device)."""

import numpy as np
import pytest

from solid_dsp_tpu.utils import sequences as jseq
from solid_dsp_tpu_torch.utils import sequences as tseq


@pytest.mark.parametrize("root,L,shift", [(5, 127, 0), (25, 63, 3),
                                          (1, 839, 0), (7, 64, 1)])
def test_zadoff_chu_equals_jax(root, L, shift):
    np.testing.assert_array_equal(tseq.zadoff_chu(root, L, shift),
                                  jseq.zadoff_chu(root, L, shift))


@pytest.mark.parametrize("nbits", sorted(n for n in jseq.MSEQ_TAPS
                                         if n <= 15))   # 23: 2^23 steps
def test_m_sequence_equals_jax(nbits):
    np.testing.assert_array_equal(tseq.m_sequence(nbits, seed=3),
                                  jseq.m_sequence(nbits, seed=3))


@pytest.mark.parametrize("nbits,count", [(5, None), (7, 10), (10, 4)])
def test_gold_codes_equal_jax(nbits, count):
    np.testing.assert_array_equal(tseq.gold_codes(nbits, count),
                                  jseq.gold_codes(nbits, count))


def test_validation_as_jax():
    for fn, args in ((tseq.zadoff_chu, (2, 64)), (tseq.zadoff_chu, (1, 0)),
                     (tseq.m_sequence, (8,)), (tseq.gold_codes, (4,)),
                     (tseq.m_sequence, (5, None, 0))):
        with pytest.raises(ValueError):
            fn(*args)
