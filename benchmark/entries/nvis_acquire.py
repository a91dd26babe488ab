"""Entry kind ``nvis_acquire``: NVIS frames (OFDM_COX on the no-pilot
1,024-FFT plan, coherent QAM, several codewords a frame) found by their
Schmidl-Cox preamble at a carrier offset.

One step: ``ofdm/pipeline.tx_cox_frame`` (each buffer [lead zeros]
[silence, 4 STS, 2 LTS][the frame's interleaved codewords][tail zeros];
encode, interleave and modulation one CUDA graph replay on the card) ->
``sim/watterson.apply_cfo_hilbert`` at the traffic file's ``cfo_hz`` ->
``sim/watterson.add_noise_with`` -> ``sync/schmidl_cox.decode_cox_batch``
(``detect_preamble`` through the window kernel ``csrc/sc_windows.cu`` and
the LTS timing kernel ``csrc/lts_timing.cu``, which also estimates the
CFO; each frame cut at its detected first LTS, the LTS estimate and the
coherent refined path at the detected CFO, one CUDA graph replay; the
deinterleave, ``csrc/ldpc_minsum.cu``).  The receiver does not know where
the frame lies or its offset.

``correct`` holds each stage to the plain float32 reference
(``benchmark/reference/nvis.py``) on the program's own input: the TX on
the info bits, the channel on the program's TX, the receiver on the
program's noisy buffer.  It compares the detection and its CFO (the
plateau's near-ties resolved to the program's point, ``SYNC_TIE``), the
refined path's LLRs that the decoder reads (on the lanes both sides
found alike and decoded: the share of lanes apart, ``llr_lanes``, and
``llr_err`` on the rest), the
bits, the ok flags and all of a frame's LDPC iteration counts.

The configuration file gives ``ModemConfig``'s plan fields, the data's
``data_modulation``, a ``code_rate`` and the ``codewords`` a frame; LDPC
messages run in float32, pinned by ``ops/ldpc.default_msg_dtype``.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch

from projectultra_tpu_torch import CodeRate, Modulation
from projectultra_tpu_torch import config as port_config
from projectultra_tpu_torch.ofdm import demodulator as D
from projectultra_tpu_torch.ofdm import pipeline as P
from projectultra_tpu_torch.ops import cuda_awgn, cuda_ldpc, cuda_lts, \
    cuda_sc
from projectultra_tpu_torch.ops import ldpc as ldpc_ops
from projectultra_tpu_torch.sim import watterson as W
from projectultra_tpu_torch.sync import schmidl_cox as SC

from .. import compare
from ..reference import channel as ref_channel
from ..reference import config as ref_config
from ..reference import ldpc as ref_ldpc
from ..reference import nvis as ref_nvis
from .cox_acquire import CORR_KEYS, DET_KEYS, LLR_TOL, plan

PATH = "acquired"
TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"
#: Two points of the Schmidl-Cox plateau whose metrics lie within this of
#: each other are a tie (twice ``corr_err``'s limit): at 30 dB the
#: plateau over the 96-sample CP is flat to ~1e-6, and the window kernel
#: and the reference's cumulative sums order such points differently.
#: The reference takes the program's point at a tie, and reads its CFO
#: there.
SYNC_TIE = 2.4e-5
#: Bits a frame's iteration counts are packed by (each count <= 50).
ITERS_BITS = 6


def packed_iters(iters: torch.Tensor) -> torch.Tensor:
    """[B, ncw] iteration counts -> [B] int64 holding all of them, so two
    lanes' packed counts are equal exactly when every codeword's is."""
    shift = ITERS_BITS * torch.arange(iters.shape[-1], device=iters.device)
    return (iters.to(torch.int64) << shift).sum(-1)


class Entry:
    """The Schmidl-Cox-acquired NVIS receiver of one configuration."""

    path = PATH

    def __init__(self, config: dict, traffic, device: torch.device):
        self.traffic, self.device = traffic, device
        self.cfg = plan(port_config, config)
        self.ref_cfg = plan(ref_config, config)
        self.mod = Modulation[config["data_modulation"]]
        self.ref_mod = ref_config.Modulation[config["data_modulation"]]
        self.rate = CodeRate[config["code_rate"]]
        self.ref_rate = ref_config.CodeRate[config["code_rate"]]
        self.ncw = int(config["codewords"])
        self.lead, self.tail = int(config["lead"]), int(config["tail"])
        self.cfo_hz = float(json.loads(
            (TRAFFIC / f"{traffic.name}.json").read_text())["cfo_hz"])
        self.k = ref_ldpc.CODE_PARAMS[self.ref_rate][0] * self.ncw
        self.n = ref_ldpc.BLOCK_LENGTH
        cp = self.cfg.cyclic_prefix
        if cp != int(config["cyclic_prefix"]):
            raise ValueError(f"a CP of {cp} samples, the configuration "
                             f"states {config['cyclic_prefix']}")
        S = P.num_data_symbols(self.cfg, self.mod, self.ncw)
        self.T = self.lead + 7 * (self.cfg.fft_size + cp) \
            + S * self.cfg.symbol_duration + self.tail
        if self.T != int(config["frame_samples"]):
            raise ValueError(f"buffer of {self.T} samples, the configuration "
                             f"states {config['frame_samples']}")
        self.edges = ref_ldpc.get_code(self.ref_rate).edges
        #: The control's precision (``benchmark/calibrate.py`` only).
        self.control = False
        # A program without the refined path's graph counters cannot run
        # this cell: it fails here, before any step.
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
        with the detection's correlations and CFO and the refined path's
        LLRs stored in bfloat16 where they are made."""
        if not self.control:
            return SC.decode_cox_batch(self.cfg, self.mod, self.rate, rx,
                                       n_codewords=self.ncw, with_llrs=True)
        det = dict(SC.detect_preamble(self.cfg, rx))
        for key in ("cfo_hz", *CORR_KEYS):
            det[key] = self._stored(det[key])
        llrs = self._stored(SC.demodulate_detected(self.cfg, self.mod, rx,
                                                   det, self.ncw))
        bits, ok, iters = P.pipeline_for(self.cfg, self.mod, self.rate,
                                         self.ncw, rx.device).decode(llrs)
        return bits, ok & det["found"], iters, det, llrs

    def step(self, info: torch.Tensor, noise: torch.Tensor, mark) -> dict:
        mark("tx")
        tx = self._stored(P.tx_cox_frame(self.cfg, self.mod, self.rate, info,
                                         lead=self.lead, tail=self.tail,
                                         n_codewords=self.ncw))
        mark("channel")
        rx = self._stored(W.add_noise_with(
            W.apply_cfo_hilbert(tx, self.cfo_hz), self.traffic.snr_db,
            noise))
        mark("rx")
        bits, ok, iters, det, llrs = self._receive(rx)
        return {"tx": tx, "rx": rx, "bits": bits, "ok": ok, "iters": iters,
                "det": det, "llrs": llrs}

    def tally(self, out: dict, info: torch.Tensor) -> torch.Tensor:
        errors = (out["bits"] != info.to(torch.uint8)).sum()
        return torch.stack([out["ok"].sum(), errors])

    @staticmethod
    def counters() -> dict:
        return {"ldpc_minsum": cuda_ldpc.launches,
                "ldpc_minsum_bf16": cuda_ldpc.launches_bf16,
                "sc_windows": cuda_sc.launches,
                "lts_timing": cuda_lts.launches,
                "awgn_active": cuda_awgn.launches,
                "refined_captures": D.refined_captures,
                "refined_replays": D.refined_replays,
                "tx_captures": P.tx_captures,
                "tx_replays": P.tx_replays}

    def reference(self):
        return ref_nvis.Nvis(self.ref_cfg, self.ref_mod, self.ref_rate,
                             self.ncw, self.lead, self.tail, self.device)

    def compare(self, ref, info: torch.Tensor, noise: torch.Tensor,
                out: dict) -> compare.Tally:
        t = compare.Tally()
        t.signal("tx", out["tx"], ref.tx(info))
        t.signal("rx", out["rx"], ref_channel.add_noise_with(
            ref_nvis.apply_cfo(out["tx"], self.cfo_hz), self.traffic.snr_db,
            noise))
        bits, ok, iters, det, llrs = ref.rx(out["rx"],
                                            out["det"]["sync_off"], SYNC_TIE)
        differ = t.detection(out["det"], det, DET_KEYS, CORR_KEYS)
        same = ~differ
        if bool(same.any()):
            t.signal("cfo", out["det"]["cfo_hz"][same], det["cfo_hz"][same])
        # The refined path's LLRs where both sides found the frame at the
        # same place and decoded it; a lane apart (a decision-directed
        # step at a near-tie) is a share of its own (``llr_lanes``), and
        # llr_err is read on the others.
        t._note("llr_lanes")
        t._note("llr_err")
        both = same & out["ok"] & ok
        if bool(both.any()):
            # The LLRs the decoder reads: the carriers past the frame's
            # last codeword are empty, and their LLRs lie near 0, where
            # another float32 summation order moves them by up to ~0.01
            # and flips their sign at the +-0.5 floor.
            prog = out["llrs"][both, :self.ncw * self.n]
            want = llrs[both, :self.ncw * self.n]
            apart = (prog - want).abs().amax(-1) > LLR_TOL
            t._count("llr_lanes", apart.sum())
            if bool((~apart).any()):
                t.signal("llr", prog[~apart], want[~apart])
        t.decoded(out["bits"], out["ok"], packed_iters(out["iters"]),
                  bits, ok, packed_iters(iters), differ)
        return t
