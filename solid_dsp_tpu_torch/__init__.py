"""solid_dsp_tpu_torch — the PyTorch / CUDA port of solid_dsp_tpu.

The JAX package ``solid_dsp_tpu`` is the reference; this package is its port
to PyTorch, with the TPU's Pallas kernels rewritten by hand for NVIDIA Hopper
(``csrc/``).  The module layout mirrors the JAX package, so each counterpart
has the same path.  The port imports ``torch`` and numpy and never ``jax`` or
``solid_dsp_tpu``.

Ported so far: the receive chain's collapsed FM path (``models.rx_chain``),
with the fused DDC + FM discriminator kernel (``ops.cuda_ddc``).
"""

__version__ = "0.1.0"

from . import design, interop, models, ops, streaming  # noqa: F401
