#!/usr/bin/env python3
"""Times the port's CUDA kernels against those of an earlier checkout of
the repo, on one card, at the shapes ``chip_smoke.py`` gives them.

    mkdir -p chip_checkout/base
    git archive <commit> | tar -x -C chip_checkout/base
    python3 tools/torch_kernel_ab.py chip_checkout/base [--pairs 10]

The earlier checkout's port package is imported under another name
(``earlier_port``), so each version runs through its own wrappers and
bindings (``ops.cuda_ldpc.decode_cuda``, ``ops.cuda_sc.sc_windows_cuda``)
and is built from its own ``csrc/`` into its own ``build/``: no C
interface is copied here.  (A checkout from before the port kept its own
host modules imports them from the JAX package, ``projectultra_tpu``,
whose host modules import no jax.)

At each shape the two versions' outputs are held equal first (LDPC:
totals, ok flags and iterations; windows: rtol 2e-4, atol 2e-3), then
timed in ``--pairs`` pairs of turns, earlier then current in even pairs
and current then earlier in odd ones; a turn is the kernel's mean device
time per launch under ``torch.profiler`` (``chip_smoke.device_ms``).  Each
shape prints both medians, the range of the per-pair ratios, the pairs
the current kernel won, its bound (as ``chip_smoke.py`` counts it) and
each version's share of the bound.  The last line is a JSON object with
every row.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
from projectultra_tpu_torch.ops import cuda_ldpc, cuda_sc  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as ldpc_ops  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as SC  # noqa: E402

EARLIER = "earlier_port"


def load_earlier(checkout: Path):
    """The earlier checkout's ``projectultra_tpu_torch`` as ``earlier_port``
    (with its ``ops.ldpc``, ``ops.cuda_ldpc`` and ``ops.cuda_sc``)."""
    pkg = checkout.resolve() / "projectultra_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        EARLIER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[EARLIER] = module
    spec.loader.exec_module(module)
    for name in ("ops.ldpc", "ops.cuda_ldpc", "ops.cuda_sc"):
        importlib.import_module(f"{EARLIER}.{name}")
    return module


def pairs_of_turns(earlier_fn, current_fn, pairs: int, reps: int,
                   kernel: str) -> tuple[list, list]:
    """Per-pair device ms of each version, the order alternating."""
    earlier, current = [], []
    for p in range(pairs):
        turns = [(earlier, earlier_fn), (current, current_fn)]
        for out, fn in (turns if p % 2 == 0 else turns[::-1]):
            out.append(S.device_ms(fn, reps, kernel))
    return earlier, current


def row(kernel: str, label: str, B: int, earlier: list, current: list,
        bound_ms: float, by: str, **extra) -> dict:
    ratios = [c / e for e, c in zip(earlier, current)]
    return {"kernel": kernel, "shape": label, "B": B,
            "earlier_ms": statistics.median(earlier),
            "ms": statistics.median(current),
            "ratio_min": min(ratios), "ratio_max": max(ratios),
            "current_won": sum(r < 1.0 for r in ratios), "pairs": len(ratios),
            "earlier_all": earlier, "current_all": current,
            "bound_ms": bound_ms, "bound_by": by, **extra}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("checkout", type=Path,
                        help="an unpacked earlier checkout of the repo")
    parser.add_argument("--pairs", type=int, default=10)
    args = parser.parse_args()
    card = S.card_line()
    print(f"card: {card}", flush=True)
    dev = S.require_cuda()
    old = load_earlier(args.checkout)
    rows = []

    def ldpc_row(label, rate, llrs, reps):
        llrs = llrs.contiguous()
        graph = ldpc_ops.graph_for(S.get_code(rate), dev)
        old_graph = old.ops.ldpc.graph_for(old.get_code(rate), dev)
        new = cuda_ldpc.decode_cuda(graph, llrs)
        ref = old.ops.cuda_ldpc.decode_cuda(old_graph, llrs)
        torch.cuda.synchronize()
        S.require(all(torch.equal(x, y) for x, y in zip(new, ref)),
                  f"the two LDPC kernels disagree on {label}")
        bound_ms, by, passes = S.ldpc_bound(graph, new[1], new[2])
        earlier, current = pairs_of_turns(
            lambda: old.ops.cuda_ldpc.decode_cuda(old_graph, llrs),
            lambda: cuda_ldpc.decode_cuda(graph, llrs), args.pairs, reps,
            "ldpc_minsum_kernel")
        rows.append(row("ldpc_minsum", label, llrs.shape[0], earlier, current,
                        bound_ms, by, mean_iterations_run=passes))

    def sc_row(label, a, stride, offset, G, reps):
        new = cuda_sc.sc_windows_cuda(a, S.HALF, stride, offset, G)
        ref = old.ops.cuda_sc.sc_windows_cuda(a, S.HALF, stride, offset, G)
        torch.cuda.synchronize()
        S.require(all(bool(torch.isclose(x, y, rtol=S.WINDOW_RTOL,
                                         atol=S.WINDOW_ATOL).all())
                      for x, y in zip(new, ref)),
                  f"the two window kernels disagree on {label}")
        bound_ms, by = S.sc_bound(a.shape[0], S.HALF, stride, G)
        earlier, current = pairs_of_turns(
            lambda: old.ops.cuda_sc.sc_windows_cuda(a, S.HALF, stride, offset,
                                                    G),
            lambda: cuda_sc.sc_windows_cuda(a, S.HALF, stride, offset, G),
            args.pairs, reps, "sc_windows_kernel")
        rows.append(row("sc_windows", label, a.shape[0], earlier, current,
                        bound_ms, by))

    # LDPC: the presynced path's 17 dB LLRs, the waterfall batch, a Cox
    # buffer's LLRs, the chirp cell's R1/4 LLRs.
    _, deint, _ = S.phase_main_path(dev)
    ldpc_row("R1/2 17 dB main path", S.RATE, deint, 20)
    wf = torch.from_numpy(S.waterfall_llrs(S.RATE, 0.62, S.BATCH)).to(dev)
    ldpc_row("R1/2 waterfall sigma=0.62", S.RATE, wf, 5)
    _, tx = S.cox_tx(dev, 10)
    rx = S.noisy_buffers(tx, torch.Generator(device=dev).manual_seed(20),
                         1)[0]
    det = SC.detect_preamble(S.COX_CFG, rx)
    pipe = S.P.pipeline_for(S.COX_CFG, S.MOD, S.RATE, 1, dev)
    ldpc_row("R1/2 17 dB Cox buffer", S.RATE, pipe.deinterleave(
        SC.demodulate_detected(S.COX_CFG, S.MOD, rx, det)), 20)
    _, ctx = S.chirp_tx(dev, 30)
    crx = S.noisy_buffers(ctx, torch.Generator(device=dev).manual_seed(35),
                          1, S.CHIRP_SNR_DB)[0]
    ldpc_row("R1/4 5 dB chirp cell", S.CHIRP_RATE, S.chirp_llrs(crx), 20)

    # Window sums on the Cox buffer's analytic signal, strides 8 and 1.
    a = SC.analytic_signal(rx)
    for stride, (st, off, G) in S.window_shapes(S.COX_T).items():
        sc_row(f"Cox buffer, T={S.COX_T}, stride {stride}, G={G}", a, st,
               off, G, 50 if stride == 8 else 10)

    for r in rows:
        print(f"{r['kernel']} [{r['shape']}, B={r['B']}]: earlier "
              f"{r['earlier_ms']!r} ms, current {r['ms']!r} ms (medians of "
              f"{r['pairs']} pairs; current/earlier per pair "
              f"{r['ratio_min']!r}-{r['ratio_max']!r}, current faster in "
              f"{r['current_won']} of {r['pairs']}), bound {r['bound_ms']!r} "
              f"ms ({r['bound_by']}), share of bound "
              f"{r['bound_ms'] / r['earlier_ms']!r} -> "
              f"{r['bound_ms'] / r['ms']!r} on {card}", flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
