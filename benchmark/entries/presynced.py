"""Entry kind ``presynced``: the port's presynced OFDM frame pipeline.

One step: ``ofdm/pipeline.tx_frame`` -> ``sim/watterson.add_noise_with``
-> ``ofdm/pipeline.rx_frame`` (the demodulator's fast path, the demap,
the deinterleave, ``ops/ldpc.decode_totals`` -> ``csrc/ldpc_minsum.cu``).

The configuration file names an OFDM plan (``fft_size``,
``num_carriers``, ``use_pilots``), a ``modulation`` and a ``code_rate``;
LDPC messages run in float32, pinned by ``ops/ldpc.default_msg_dtype``.
"""

from __future__ import annotations

import contextlib

import torch

from projectultra_tpu_torch import CodeRate, ModemConfig, Modulation
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import cuda_ldpc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.sim import watterson as W

from .. import compare
from ..reference import channel as ref_channel
from ..reference import config as ref_config
from ..reference import ldpc as ref_ldpc
from ..reference import ofdm as ref_ofdm

PATH = "presynced"
PLAN_KEYS = ("fft_size", "num_carriers", "use_pilots")


class Entry:
    """The presynced pipeline of one configuration on one device."""

    path = PATH

    def __init__(self, config: dict, traffic, device: torch.device):
        self.traffic, self.device = traffic, device
        self.mod = Modulation[config["modulation"]]
        self.rate = CodeRate[config["code_rate"]]
        plan = {key: config[key] for key in PLAN_KEYS}
        self.cfg = ModemConfig(modulation=self.mod, code_rate=self.rate,
                               **plan)
        self.ref_cfg = ref_config.ModemConfig(
            modulation=ref_config.Modulation[config["modulation"]],
            code_rate=ref_config.CodeRate[config["code_rate"]], **plan)
        self.k = ref_ldpc.CODE_PARAMS[ref_config.CodeRate[
            config["code_rate"]]][0]
        self.n = ref_ldpc.BLOCK_LENGTH
        self.T = P.frame_samples(self.cfg, self.mod)
        if self.T != int(config["frame_samples"]):
            raise ValueError(f"frame of {self.T} samples, the configuration "
                             f"states {config['frame_samples']}")
        self.edges = ref_ldpc.get_code(self.ref_cfg.code_rate).edges
        #: The control's precision (``benchmark/calibrate.py`` only).
        self.control = False

    @contextlib.contextmanager
    def precision(self):
        """The configuration's precision: float32 LDPC messages; the
        control's, bfloat16 ones (the program's own fast mode)."""
        msg = torch.bfloat16 if self.control else torch.float32
        with ldpc_ops.default_msg_dtype(msg):
            yield

    def _stored(self, x: torch.Tensor) -> torch.Tensor:
        """x as the control keeps it: rounded to bfloat16 where made."""
        return x.to(torch.bfloat16).to(torch.float32) if self.control else x

    def step(self, info: torch.Tensor, noise: torch.Tensor, mark) -> dict:
        mark("tx")
        tx = self._stored(P.tx_frame(self.cfg, self.mod, self.rate, info))
        mark("channel")
        rx = self._stored(W.add_noise_with(tx, self.traffic.snr_db, noise))
        mark("rx")
        bits, ok, iters = P.rx_frame(self.cfg, self.mod, self.rate, rx)
        return {"tx": tx, "rx": rx, "bits": bits, "ok": ok,
                "iters": iters[:, 0]}

    def tally(self, out: dict, info: torch.Tensor) -> torch.Tensor:
        """[ok frames, bit errors] of the step, on the device."""
        errors = (out["bits"] != info.to(torch.uint8)).sum()
        return torch.stack([out["ok"].sum(), errors])

    @staticmethod
    def counters() -> dict:
        return {"ldpc_minsum": cuda_ldpc.launches,
                "ldpc_minsum_bf16": cuda_ldpc.launches_bf16}

    def reference(self):
        return ref_ofdm.Pipeline(self.ref_cfg, self.ref_cfg.modulation,
                                 self.ref_cfg.code_rate, self.device)

    def compare(self, ref, info: torch.Tensor, noise: torch.Tensor,
                out: dict) -> compare.Tally:
        """The reference on a block of rows of one step, against the
        program's outputs of those rows."""
        tx = ref.tx(info)
        rx = ref_channel.add_noise_with(tx, self.traffic.snr_db, noise)
        bits, ok, iters = ref.rx(rx)
        t = compare.Tally()
        t.signal("tx", out["tx"], tx)
        t.signal("rx", out["rx"], rx)
        t.decoded(out["bits"], out["ok"], out["iters"],
                  bits, ok, iters)
        return t
