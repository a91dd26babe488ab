"""projectultra_tpu_torch — the PyTorch/CUDA port of the modem.

The port keeps the layout and names of the JAX package ``projectultra_tpu``
(``ops/ldpc.py``, ``ofdm/pipeline.py``, ...), which stays the reference it
is tested against.  The port keeps its own copies of the host-side numpy
modules (``config``, ``fec.ldpc``, ``ofdm.carriers``,
``ofdm.constellations``, ``utils.mt19937``), pinned equal to the
originals by ``tests/test_torch_host.py``.  The port imports neither jax
nor anything of the JAX package.

On CUDA tensors six hand-written CUDA sources for Hopper run, each built
and loaded through ``ops/cuda_build.py`` and called from its wrapper
``ops/cuda_*.py``:

* ``csrc/ldpc_minsum.cu``, the LDPC min-sum decoder in float32 and
  bfloat16-message instantiations (``ops/ldpc.decode_totals``);
* ``csrc/sc_windows.cu``, the Schmidl-Cox window sums of preamble
  acquisition (``ops/sc_windows.sc_windows``);
* ``csrc/lts_timing.cu``, Schmidl-Cox LTS fine timing at each lane's
  search window (``sync/schmidl_cox.lts_timing``);
* ``csrc/pilot_track.cu``, one symbol's pilot tracking, equalization and
  DQPSK demap inside the pilot-tracking scan
  (``ofdm/demodulator._fused_tracking``);
* ``csrc/chirp_decimate.cu``, chirp acquisition's decimating FIR
  (``sync/chirp._decimate``);
* ``csrc/dpsk_score.cu``, DPSK's preamble score
  (``ops/dpsk_score.dpsk_score``).

The plain PyTorch version beside each kernel is its test oracle and the
CPU path.

The port's ``ModemConfig``, the enums ``CodeRate`` and ``Modulation`` and
the code table lookup ``get_code`` are re-exported here.
"""

from .config import CodeRate, ModemConfig, Modulation
from .fec.ldpc import get_code
from .device import pin_float32, require_cuda

pin_float32()

__all__ = ["CodeRate", "ModemConfig", "Modulation", "get_code",
           "pin_float32", "require_cuda"]
