"""projectultra_tpu_torch — the PyTorch/CUDA port of the modem.

The port keeps the layout and names of the JAX package ``projectultra_tpu``
(``ops/ldpc.py``, ``ofdm/pipeline.py``, ...), which stays the reference it
is tested against.  Host-side numpy modules that never import jax
(``config``, ``fec.ldpc``, ``ofdm.carriers``, ``ofdm.constellations``,
``utils.mt19937``) are shared with the JAX package, not copied.  The port
never imports jax.

On CUDA tensors two hand-written kernels for Hopper run: the LDPC min-sum
decoder (``csrc/ldpc_minsum.cu``) and the Schmidl-Cox window sums of
preamble acquisition (``csrc/sc_windows.cu``); the plain PyTorch versions
beside each kernel are test oracles and the CPU path.

The shared ``ModemConfig``, the enums ``CodeRate`` and ``Modulation`` and
the code table lookup ``get_code`` are re-exported here, so a caller of
the port needs no import of the JAX package.
"""

from projectultra_tpu.config import CodeRate, ModemConfig, Modulation
from projectultra_tpu.fec.ldpc import get_code

from .device import pin_float32, require_cuda

pin_float32()

__all__ = ["CodeRate", "ModemConfig", "Modulation", "get_code",
           "pin_float32", "require_cuda"]
