"""projectultra_tpu_torch — the PyTorch/CUDA port of the modem.

The port keeps the layout and names of the JAX package ``projectultra_tpu``
(``ops/ldpc.py``, ``ofdm/pipeline.py``, ...), which stays the reference it
is tested against.  The port keeps its own copies of the host-side numpy
modules (``config``, ``fec.ldpc``, ``ofdm.carriers``,
``ofdm.constellations``, ``utils.mt19937``), pinned equal to the
originals by ``tests/test_torch_host.py``.  The port imports neither jax
nor anything of the JAX package.

On CUDA tensors two hand-written kernels for Hopper run: the LDPC min-sum
decoder (``csrc/ldpc_minsum.cu``) and the Schmidl-Cox window sums of
preamble acquisition (``csrc/sc_windows.cu``); the plain PyTorch versions
beside each kernel are test oracles and the CPU path.

The port's ``ModemConfig``, the enums ``CodeRate`` and ``Modulation`` and
the code table lookup ``get_code`` are re-exported here.
"""

from .config import CodeRate, ModemConfig, Modulation
from .fec.ldpc import get_code
from .device import pin_float32, require_cuda

pin_float32()

__all__ = ["CodeRate", "ModemConfig", "Modulation", "get_code",
           "pin_float32", "require_cuda"]
