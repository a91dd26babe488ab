"""Entry kind ``dpsk_acquire``: single-carrier DPSK frames found by their
Barker-13x3 preamble.

One step: ``psk/dpsk.tx_dpsk_frame`` (each buffer [lead zeros][39 preamble
symbols][one LDPC codeword][tail zeros]) -> ``sim/watterson.add_noise_with``
(one ``csrc/awgn_active.cu`` launch on the card) ->
``psk/dpsk.decode_dpsk_batch`` (``find_preamble`` over the whole buffer:
the FFT matched filter's symbol correlations, the differential score of
``csrc/dpsk_score.cu``, rules A and B, the CFO and phase estimates, the
matched-filter refine; each frame cut at its data start,
``demodulate_soft``, ``csrc/ldpc_minsum.cu``).  The receiver does not
know where the frame lies.  ``correct`` holds the TX, the channel on the
program's TX, and on the program's noisy buffer the detection (found,
data start, the reference symbol, CFO, initial phase), the demodulated
LLRs (on the lanes both sides found alike: the share of lanes apart,
``llr_lanes``, and ``llr_err`` on the rest) and the decode to the plain
float32 reference (``benchmark/reference/dpsk.py``).

The configuration file gives the preset's fields, a ``code_rate`` and the
buffer's ``lead`` and ``tail``; LDPC messages run in float32, pinned by
``ops/ldpc.default_msg_dtype``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from projectultra_tpu_torch import CodeRate
from projectultra_tpu_torch.fec import ldpc as ldpc_codes
from projectultra_tpu_torch.ops import cuda_awgn, cuda_dpsk, cuda_ldpc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.psk import dpsk as DP
from projectultra_tpu_torch.sim import watterson as W

from .. import compare
from ..reference import channel as ref_channel
from ..reference import config as ref_config
from ..reference import dpsk as ref_dpsk
from ..reference import ldpc as ref_ldpc

PATH = "acquired"
#: Detection outputs held equal to the reference's, and the reference
#: symbol compared on the lanes where they agree (``corr_err``); the CFO
#: and the initial phase are compared as signals of their own, against the
#: reference's estimates at the ties of its coarse peak.
DET_KEYS = ("found", "data_start")
CORR_KEYS = ("prev_symbol",)
#: A lane's demodulated LLRs (which lie in [-5, 5]) are apart from the
#: reference's when one of them differs by more than this.
LLR_TOL = 0.01


class Entry:
    """The preamble-acquired single-carrier DPSK receiver of one
    configuration."""

    path = PATH

    def __init__(self, config: dict, traffic, device: torch.device):
        self.traffic, self.device = traffic, device
        self.cfg = DP.DPSKConfig(
            sample_rate=float(config["sample_rate"]),
            carrier_freq=float(config["carrier_freq"]),
            samples_per_symbol=int(config["samples_per_symbol"]),
            modulation=DP.DPSKModulation[config["modulation"]],
            rolloff=float(config["rolloff"]),
            use_pulse_shaping=bool(config["use_pulse_shaping"]))
        if self.cfg != getattr(DP, config["preset"])():
            raise ValueError(f"the fields are not the {config['preset']} "
                             f"preset's")
        if self.cfg.modulation != DP.DPSKModulation.DQPSK:
            raise ValueError("the reference runs DQPSK only")
        self.ref_cfg = ref_dpsk.DPSKConfig(
            sample_rate=self.cfg.sample_rate,
            carrier_freq=self.cfg.carrier_freq,
            samples_per_symbol=self.cfg.samples_per_symbol,
            use_pulse_shaping=self.cfg.use_pulse_shaping)
        self.rate = CodeRate[config["code_rate"]]
        self.ref_rate = ref_config.CodeRate[config["code_rate"]]
        self.lead, self.tail = int(config["lead"]), int(config["tail"])
        self.k = ref_ldpc.CODE_PARAMS[self.ref_rate][0]
        self.n = ref_ldpc.BLOCK_LENGTH
        # A program without the DPSK frame TX cannot run this cell: it
        # fails here, before any step.
        self.T = DP.frame_samples(self.cfg, self.rate, self.lead, self.tail)
        if self.T != int(config["frame_samples"]) or self.T != \
                ref_dpsk.frame_samples(self.ref_cfg, self.ref_rate,
                                       self.lead, self.tail):
            raise ValueError(f"buffer of {self.T} samples, the configuration "
                             f"states {config['frame_samples']}")
        self.edges = ref_ldpc.get_code(self.ref_rate).edges
        #: Radians a symbol turns at 1 Hz of CFO.
        self.per_symbol = 2 * math.pi * self.cfg.samples_per_symbol \
            / self.cfg.sample_rate
        #: The control's precision (``benchmark/calibrate.py`` only).
        self.control = False

    @contextlib.contextmanager
    def precision(self):
        """The configuration's precision: float32 LDPC messages; the
        control's, the program's bfloat16 messages."""
        msg = torch.bfloat16 if self.control else torch.float32
        with ldpc_ops.default_msg_dtype(msg):
            yield

    def _stored(self, x: torch.Tensor) -> torch.Tensor:
        if not self.control:
            return x
        if x.is_complex():
            return torch.view_as_complex(
                torch.view_as_real(x).to(torch.bfloat16).to(torch.float32))
        return x.to(torch.bfloat16).to(torch.float32)

    def _receive(self, rx: torch.Tensor):
        """``decode_dpsk_batch`` with its LLRs; the control runs its stages
        with the detection's reference symbol, CFO and phase and the
        demodulated LLRs stored in bfloat16 where they are made."""
        if not self.control:
            return DP.decode_dpsk_batch(self.cfg, self.rate, rx,
                                        with_llrs=True)
        found, ds, *est = DP.find_preamble(self.cfg, rx)
        cfo, ipo, prev = (self._stored(x) for x in est)
        llrs = self._stored(DP.demodulate_detected(self.cfg, self.rate, rx,
                                                   ds, prev, cfo, ipo))
        graph = ldpc_ops.graph_for(ldpc_codes.get_code(self.rate), rx.device)
        llr_total, ok, iters = ldpc_ops.decode_totals(graph, llrs)
        bits = (llr_total[:, :self.k] < 0).to(torch.uint8)
        det = {"found": found, "data_start": ds, "cfo_hz": cfo,
               "initial_phase_offset": ipo, "prev_symbol": prev}
        return bits, ok & found, iters, det, llrs

    def step(self, info: torch.Tensor, noise: torch.Tensor, mark) -> dict:
        mark("tx")
        tx = self._stored(DP.tx_dpsk_frame(self.cfg, self.rate, info,
                                           self.lead, self.tail))
        mark("channel")
        rx = self._stored(W.add_noise_with(tx, self.traffic.snr_db, noise))
        mark("rx")
        bits, ok, iters, det, llrs = self._receive(rx)
        return {"tx": tx, "rx": rx, "bits": bits, "ok": ok, "iters": iters,
                "det": det, "llrs": llrs}

    def tally(self, out: dict, info: torch.Tensor) -> torch.Tensor:
        errors = (out["bits"] != info.to(torch.uint8)).sum()
        return torch.stack([out["ok"].sum(), errors])

    @staticmethod
    def counters() -> dict:
        return {"dpsk_score": cuda_dpsk.launches,
                "ldpc_minsum": cuda_ldpc.launches,
                "ldpc_minsum_bf16": cuda_ldpc.launches_bf16,
                "awgn_active": cuda_awgn.launches}

    def reference(self):
        return None

    def compare(self, ref, info: torch.Tensor, noise: torch.Tensor,
                out: dict) -> compare.Tally:
        # Each stage on the program's own input: the harness channel counts
        # the samples above 1e-6, and the carrier's zero crossings fall on
        # samples (w = 2 pi / 32, phases in steps of pi / 4), so a TX phase
        # one float32 ulp apart (the card's scan of the phase sums in
        # another order at another batch) moves ~0.5% of the samples across
        # it and the noise power by as much.
        tx = ref_dpsk.tx(self.ref_cfg, self.ref_rate, info, self.lead,
                         self.tail)
        rx = ref_channel.add_noise_with(out["tx"], self.traffic.snr_db,
                                        noise)
        bits, ok, iters, det, llrs = ref_dpsk.rx(self.ref_cfg, self.ref_rate,
                                                 out["rx"])
        t = compare.Tally()
        t.signal("tx", out["tx"], tx)
        t.signal("rx", out["rx"], rx)
        differ = t.detection(out["det"], det, DET_KEYS, CORR_KEYS)
        same = ~differ
        # The CFO and the initial phase come from the coarse peak, which
        # lies on a plateau of near-tied scores: both are held to the
        # reference's estimates at the tie nearest them (the CFO as the
        # phase it turns in a symbol, plus the phase).
        t._note("cfo_err")
        t._note("phase_err")
        if bool(same.any()):
            cfo = out["det"]["cfo_hz"][same]
            phase = out["det"]["initial_phase_offset"][same]
            ties_cfo, ties_phase = det["cfo_ties"][same], \
                det["phase_ties"][same]
            apart = (ties_cfo - cfo[:, None]).abs() * self.per_symbol \
                + (ties_phase - phase[:, None]).abs()
            nearest = apart.nan_to_num(nan=math.inf).argmin(-1, keepdim=True)
            t.signal("cfo", cfo, ties_cfo.gather(1, nearest)[:, 0])
            t.signal("phase", phase, ties_phase.gather(1, nearest)[:, 0])
        # The LLRs where both sides found the frame at the same place.  A
        # lane whose phase compensation takes the other branch at a
        # near-tie of its gates ends apart; such lanes are a share of their
        # own, and llr_err is read on the others.
        t._note("llr_lanes")
        t._note("llr_err")
        if bool(same.any()):
            apart = (out["llrs"][same] - llrs[same]).abs().amax(-1) > LLR_TOL
            t._count("llr_lanes", apart.sum())
            near = same.clone()
            near[same] = ~apart
            if bool(near.any()):
                t.signal("llr", out["llrs"][near], llrs[near])
        t.decoded(out["bits"], out["ok"], out["iters"], bits, ok, iters,
                  differ)
        return t
