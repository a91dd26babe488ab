"""Entry kind ``cox_acquire``: OFDM_COX frames found by their Schmidl-Cox
preamble.

One step: ``ofdm/pipeline.tx_cox_frame`` (each buffer [lead zeros]
[silence, 4 STS, 2 LTS][the data symbols with pilots][tail zeros]) ->
``sim/watterson.add_noise_with`` -> ``sync/schmidl_cox.decode_cox_batch``
(``detect_preamble`` over the whole buffer through the window kernel
``csrc/sc_windows.cu``, each frame cut at its detected first LTS, the LTS
channel estimate and the pilot-tracking scan at the detected CFO, one
CUDA graph replay with one ``csrc/pilot_track.cu`` launch a symbol, the
deinterleave, ``csrc/ldpc_minsum.cu``).  The receiver does not know where
the frame lies.  ``correct`` holds the TX, the channel, the detection, the
scan's demodulated LLRs (on the lanes both sides found alike and decoded:
the share of lanes apart, ``llr_lanes``, and ``llr_err`` on the rest) and
the decode to the plain float32 reference.

The configuration file gives ``ModemConfig``'s plan fields, the data's
``data_modulation`` and a ``code_rate``; LDPC messages run in float32,
pinned by ``ops/ldpc.default_msg_dtype``.
"""

from __future__ import annotations

import contextlib

import torch

from projectultra_tpu_torch import CodeRate, Modulation
from projectultra_tpu_torch import config as port_config
from projectultra_tpu_torch.ofdm import demodulator as D
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc, cuda_track
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import schmidl_cox as SC

from .. import compare
from ..reference import channel as ref_channel
from ..reference import config as ref_config
from ..reference import ldpc as ref_ldpc
from ..reference import ofdm_cox as ref_cox

PATH = "acquired"
PLAN_KEYS = ("sample_rate", "center_freq", "fft_size", "num_carriers",
             "symbol_guard", "pilot_spacing", "use_pilots",
             "scattered_pilots", "adaptive_eq_enabled", "output_scale",
             "sync_threshold")
#: Detection outputs held equal to the reference's, and its correlations;
#: the detected CFO is compared as a signal of its own (``cfo_err``).
DET_KEYS = ("found", "lts_start", "sync_off")
CORR_KEYS = ("peak_corr", "lts_corr")
#: A lane's demodulated LLRs (which lie in [-10, 10]) are apart from the
#: reference's when one of them differs by more than this.
LLR_TOL = 0.01


def plan(module, config: dict):
    """``module.ModemConfig`` (the port's or the reference's) of the
    configuration's plan."""
    return module.ModemConfig(
        cp_mode=module.CyclicPrefixMode[config["cp_mode"]],
        modulation=module.Modulation[config["modulation"]],
        code_rate=module.CodeRate[config["code_rate"]],
        **{key: config[key] for key in PLAN_KEYS})


class Entry:
    """The Schmidl-Cox-acquired OFDM receiver of one configuration."""

    path = PATH

    def __init__(self, config: dict, traffic, device: torch.device):
        self.traffic, self.device = traffic, device
        self.cfg = plan(port_config, config)
        self.ref_cfg = plan(ref_config, config)
        self.mod = Modulation[config["data_modulation"]]
        self.ref_mod = ref_config.Modulation[config["data_modulation"]]
        self.rate = CodeRate[config["code_rate"]]
        self.ref_rate = ref_config.CodeRate[config["code_rate"]]
        self.lead, self.tail = int(config["lead"]), int(config["tail"])
        self.k = ref_ldpc.CODE_PARAMS[self.ref_rate][0]
        self.n = ref_ldpc.BLOCK_LENGTH
        cp = self.cfg.cyclic_prefix
        if cp != int(config["cyclic_prefix"]):
            raise ValueError(f"a CP of {cp} samples, the configuration "
                             f"states {config['cyclic_prefix']}")
        S = P.num_data_symbols(self.cfg, self.mod)
        self.T = self.lead + 7 * (self.cfg.fft_size + cp) \
            + S * self.cfg.symbol_duration + self.tail
        if self.T != int(config["frame_samples"]):
            raise ValueError(f"buffer of {self.T} samples, the configuration "
                             f"states {config['frame_samples']}")
        self.edges = ref_ldpc.get_code(self.ref_rate).edges
        #: The control's precision (``benchmark/calibrate.py`` only).
        self.control = False
        # A program without the scan's graph counters cannot run this
        # cell: it fails here, before any step.
        self.counters()

    @contextlib.contextmanager
    def precision(self):
        """The configuration's precision: float32 LDPC messages; the
        control's, the program's bfloat16 messages."""
        msg = torch.bfloat16 if self.control else torch.float32
        with ldpc_ops.default_msg_dtype(msg):
            yield

    def _stored(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(torch.float32) if self.control else x

    def _receive(self, rx: torch.Tensor):
        """``decode_cox_batch`` with its LLRs; the control runs its stages
        with the scan's LLRs stored in bfloat16 where they are made."""
        if not self.control:
            return SC.decode_cox_batch(self.cfg, self.mod, self.rate, rx,
                                       with_llrs=True)
        det = SC.detect_preamble(self.cfg, rx)
        llrs = self._stored(SC.demodulate_detected(self.cfg, self.mod, rx,
                                                   det))
        bits, ok, iters = P.pipeline_for(self.cfg, self.mod, self.rate, 1,
                                         rx.device).decode(llrs)
        return bits, ok & det["found"], iters, det, llrs

    def step(self, info: torch.Tensor, noise: torch.Tensor, mark) -> dict:
        mark("tx")
        tx = self._stored(P.tx_cox_frame(self.cfg, self.mod, self.rate, info,
                                         lead=self.lead, tail=self.tail))
        mark("channel")
        rx = self._stored(W.add_noise_with(tx, self.traffic.snr_db, noise))
        mark("rx")
        bits, ok, iters, det, llrs = self._receive(rx)
        return {"tx": tx, "rx": rx, "bits": bits, "ok": ok,
                "iters": iters[:, 0], "det": det, "llrs": llrs}

    def tally(self, out: dict, info: torch.Tensor) -> torch.Tensor:
        errors = (out["bits"] != info.to(torch.uint8)).sum()
        return torch.stack([out["ok"].sum(), errors])

    @staticmethod
    def counters() -> dict:
        return {"ldpc_minsum": cuda_ldpc.launches,
                "ldpc_minsum_bf16": cuda_ldpc.launches_bf16,
                "sc_windows": cuda_sc.launches,
                "pilot_track": cuda_track.launches,
                "scan_captures": D.scan_captures,
                "scan_replays": D.scan_replays,
                "tx_captures": P.tx_captures,
                "tx_replays": P.tx_replays}

    def reference(self):
        return ref_cox.Cox(self.ref_cfg, self.ref_mod, self.ref_rate,
                           self.lead, self.tail, self.device)

    def compare(self, ref, info: torch.Tensor, noise: torch.Tensor,
                out: dict) -> compare.Tally:
        tx = ref.tx(info)
        rx = ref_channel.add_noise_with(tx, self.traffic.snr_db, noise)
        bits, ok, iters, det, llrs = ref.rx(rx)
        t = compare.Tally()
        t.signal("tx", out["tx"], tx)
        t.signal("rx", out["rx"], rx)
        differ = t.detection(out["det"], det, DET_KEYS, CORR_KEYS)
        same = ~differ
        if bool(same.any()):
            t.signal("cfo", out["det"]["cfo_hz"][same], det["cfo_hz"][same])
        # The scan's LLRs where both sides found the frame at the same place
        # and decoded it.  A lane whose tracking takes another branch at a
        # near-tie (the timing fix's |offset| > 0.1, say) ends apart; such
        # lanes are a share of their own, like detection's near-ties, and
        # llr_err is read on the others.
        t._note("llr_lanes")
        t._note("llr_err")
        both = same & out["ok"] & ok
        if bool(both.any()):
            apart = (out["llrs"][both] - llrs[both]).abs().amax(-1) > LLR_TOL
            t._count("llr_lanes", apart.sum())
            near = both.clone()
            near[both] = ~apart
            if bool(near.any()):
                t.signal("llr", out["llrs"][near], llrs[near])
        t.decoded(out["bits"], out["ok"], out["iters"], bits, ok, iters,
                  differ)
        return t
