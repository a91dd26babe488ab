"""Entry kind ``chirp_acquire``: MC-DPSK frames found by their dual chirp.

One step: ``psk/mc_dpsk.tx_chirp_frame`` (each buffer [4,800 zeros][chirp]
[training][reference][one codeword][4,000 zeros]) ->
``sim/watterson.add_noise_with`` -> ``psk/mc_dpsk.decode_chirp_batch``
(``sync/chirp.detect_dual_chirp`` over the whole buffer, each frame cut at
its detected training start, demodulated at the detected CFO, decoded).
The receiver does not know where the frame lies.

The configuration file gives ``MCDPSKConfig``'s fields and a
``code_rate``; LDPC messages and the chirp refine run in float32, pinned
by ``ops/ldpc.default_msg_dtype`` and ``sync/chirp.bf16_mode(False)``.
"""

from __future__ import annotations

import contextlib

import torch

from projectultra_tpu_torch import CodeRate
from projectultra_tpu_torch.ops import cuda_ldpc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.psk import mc_dpsk as MC
from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import chirp as CH

from .. import compare
from ..reference import channel as ref_channel
from ..reference import config as ref_config
from ..reference import ldpc as ref_ldpc
from ..reference import mc_dpsk as ref_mc

PATH = "acquired"
MC_KEYS = ("num_carriers", "samples_per_symbol", "bits_per_symbol",
           "training_symbols", "freq_low", "freq_high", "chirp_f_start",
           "chirp_f_end", "chirp_duration_ms", "use_dual_chirp",
           "chirp_threshold")
#: Detection outputs held equal to the reference's, and its correlations.
DET_KEYS = ("success", "up_chirp_start", "down_chirp_start", "cfo_hz")
CORR_KEYS = ("up_correlation", "down_correlation")


class Entry:
    """The chirp-acquired MC-DPSK receiver of one configuration."""

    path = PATH

    def __init__(self, config: dict, traffic, device: torch.device):
        self.traffic, self.device = traffic, device
        fields = {key: config[key] for key in MC_KEYS}
        self.mc = MC.MCDPSKConfig(**fields)
        self.ref_mc = ref_mc.MCDPSKConfig(**fields)
        self.rate = CodeRate[config["code_rate"]]
        self.ref_rate = ref_config.CodeRate[config["code_rate"]]
        self.k = ref_ldpc.CODE_PARAMS[self.ref_rate][0]
        self.n = ref_ldpc.BLOCK_LENGTH
        self.T = MC.frame_samples(self.mc, self.rate)
        if self.T != int(config["frame_samples"]):
            raise ValueError(f"frame of {self.T} samples, the configuration "
                             f"states {config['frame_samples']}")
        self.edges = ref_ldpc.get_code(self.ref_rate).edges
        #: The control's precision (``benchmark/calibrate.py`` only).
        self.control = False

    @contextlib.contextmanager
    def precision(self):
        """The configuration's precision: float32 LDPC messages and chirp
        refine; the control's, the program's bfloat16 modes of both."""
        msg = torch.bfloat16 if self.control else torch.float32
        with ldpc_ops.default_msg_dtype(msg), CH.bf16_mode(self.control):
            yield

    def _stored(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(torch.float32) if self.control else x

    def step(self, info: torch.Tensor, noise: torch.Tensor, mark) -> dict:
        mark("tx")
        tx = self._stored(MC.tx_chirp_frame(self.mc, self.rate, info))
        mark("channel")
        rx = self._stored(W.add_noise_with(tx, self.traffic.snr_db, noise))
        mark("rx")
        bits, ok, iters, det = MC.decode_chirp_batch(self.mc, self.rate, rx)
        return {"tx": tx, "rx": rx, "bits": bits, "ok": ok, "iters": iters,
                "det": det}

    def tally(self, out: dict, info: torch.Tensor) -> torch.Tensor:
        errors = (out["bits"] != info.to(torch.uint8)).sum()
        return torch.stack([out["ok"].sum(), errors])

    @staticmethod
    def counters() -> dict:
        return {"ldpc_minsum": cuda_ldpc.launches,
                "ldpc_minsum_bf16": cuda_ldpc.launches_bf16}

    def reference(self):
        return None

    def compare(self, ref, info: torch.Tensor, noise: torch.Tensor,
                out: dict) -> compare.Tally:
        tx = ref_mc.tx_chirp_frame(self.ref_mc, self.ref_rate, info)
        rx = ref_channel.add_noise_with(tx, self.traffic.snr_db, noise)
        bits, ok, iters, det = ref_mc.decode_chirp_batch(
            self.ref_mc, self.ref_rate, rx)
        t = compare.Tally()
        t.signal("tx", out["tx"], tx)
        t.signal("rx", out["rx"], rx)
        differ = t.detection(out["det"], det, DET_KEYS, CORR_KEYS)
        t.decoded(out["bits"], out["ok"], out["iters"],
                  bits, ok, iters, differ)
        return t
