#!/usr/bin/env python3
"""Times the port's CUDA kernels against those of an earlier checkout of
the repo, on one card, at the shapes ``chip_smoke.py`` gives them.

    mkdir -p chip_checkout/base
    git archive <commit> | tar -x -C chip_checkout/base
    python3 tools/torch_kernel_ab.py chip_checkout/base [--pairs 10] \
        [--msg bf16|f32|both] [--kernels all|ldpc|windows|awgn]

The earlier checkout's port package is imported under another name
(``earlier_port``), so each version runs through its own wrappers and
bindings (``ops.cuda_ldpc.decode_cuda``, ``ops.cuda_sc.sc_windows_cuda``)
and is built from its own ``csrc/`` into its own ``build/``: no C
interface is copied here.  (A checkout from before the port kept its own
host modules imports them from the JAX package, ``projectultra_tpu``,
whose host modules import no jax.)

``--msg`` picks the LDPC kernel's instantiations: float32 messages
(``f32``, the default), bfloat16 ones (``bf16``) or ``both``.  The LDPC
shapes: the presynced path's 17 dB LLRs and the sigma 0.62 waterfall
(B = 16,384, blocks of 256 threads), an R1/4 sigma 1.1 trap-escape batch
(B = 4,096), a Cox buffer's and the chirp cell's LLRs (B = 512 and 256,
blocks of 1,024), one never-converging R1/4 codeword with its retry and
one never-converging R1/2 codeword (B = 1, the engine's shapes).  ``--threads 256`` or ``1024`` makes both
versions launch blocks of that size at every shape instead of their own
``block_threads_for`` rule.  The window shapes: a Cox buffer's analytic
signal at strides 8 and 1 (B = 512, T = 18,856, half 256), an NVIS-sized
buffer at half 512, stride 8 (B = 512, T = 15,080), the engine's search
view (B = 1, T = 262,144) and ``test_sync_robustness``'s whole-frame
searches (B = 10, T = 39,936), both at stride 8; all but the Cox buffer
are seeded noise (the kernel's time does not depend on the values).
The AWGN channel's shapes: the presynced cells' B = 16,384 x 7,332, the
Cox cell's 2,048 x 18,856, the acquired cell's 2,048 x 83,808 and the
engine's B = 1 view of 262,144 samples (seeded normals; the time does not
depend on the values), each version through its own
``sim.watterson.add_noise_with`` (a checkout before the kernel runs the
plain version's 14 operations there): a turn is the device busy time a
call (``chip_smoke.profile_busy_ms``), the bound the 3-pass one (the
4-pass one printed beside), the outputs within the card suite's tolerance
of each other (1e-5 of std * |n| plus one ulp); where the rule takes the
cluster regime (the acquired cell) the current kernel is also timed
streaming the rows twice, the design's A/B.
``--kernels`` picks the LDPC rows, the window rows, the AWGN rows or
all.
``--tiles 128,256,512`` also times the current window kernel at each
window shape with ``cuda_sc.tile_for`` replaced by each of those tiles
(and the rule's own pick), in turns forward and back: the measurements
behind the tile rule.

At each shape the two versions' outputs are held equal first (LDPC:
totals, ok flags and iterations; windows: rtol 2e-4, atol 2e-3), then
timed in ``--pairs`` pairs of turns, earlier then current in even pairs
and current then earlier in odd ones; a turn is the kernel's mean device
time per launch under ``torch.profiler`` (``chip_smoke.device_ms``).  Each
shape prints both medians, the range of the per-pair ratios, the pairs
the current kernel won, its bound (``benchmark/yardstick.py``'s, on the
shape's own data), each version's share of the bound, each version's
registers per thread and spills (``ptxas -v`` of its build) and dynamic
shared bytes per block, and for windows the current launch's plan (tile,
items, blocks, ring stages).
The last line is a JSON object with every row.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import statistics
import sys
from pathlib import Path
from unittest import mock

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402
from benchmark import yardstick  # noqa: E402
from projectultra_tpu_torch import CodeRate  # noqa: E402
from projectultra_tpu_torch.modem.engine import ModemEngine  # noqa: E402
from projectultra_tpu_torch import ops as current_ops  # noqa: E402
from projectultra_tpu_torch.ops import cuda_build, cuda_ldpc, cuda_sc  # noqa: E402,E501
from projectultra_tpu_torch.ops import ldpc as ldpc_ops  # noqa: E402
from projectultra_tpu_torch.sync import schmidl_cox as SC  # noqa: E402

EARLIER = "earlier_port"
MSG = {"f32": (torch.float32,), "bf16": (torch.bfloat16,),
       "both": (torch.float32, torch.bfloat16)}


def load_earlier(checkout: Path):
    """The earlier checkout's ``projectultra_tpu_torch`` as ``earlier_port``
    (with its ``ops.ldpc``, ``ops.cuda_ldpc`` and ``ops.cuda_sc``)."""
    pkg = checkout.resolve() / "projectultra_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        EARLIER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[EARLIER] = module
    spec.loader.exec_module(module)
    for name in ("ops.ldpc", "ops.cuda_build", "ops.cuda_ldpc",
                 "ops.cuda_sc", "sim.watterson"):
        importlib.import_module(f"{EARLIER}.{name}")
    return module


def ldpc_key(entry: str):
    """(threads, bf16) of an LDPC kernel instantiation's mangled name."""
    m = re.search(r"ldpc_minsum_kernelILi(\d+)ELb([01])E", entry)
    return (int(m.group(1)), m.group(2) == "1") if m else None


def ptxas_usage(ops, module=None, key=ldpc_key) -> dict:
    """{key(entry): (registers, spill store bytes, spill load bytes)} of
    each kernel entry in the ``ptxas -v`` report of the library that
    ``ops`` (a port's ``ops`` package) builds from ``module``'s source
    (default ``ops.cuda_ldpc``; ``key`` names an entry, None skips it)."""
    module = module or ops.cuda_ldpc
    lib = ops.cuda_build.build(module.SOURCE, module.FLAGS)
    report = lib.with_name(f"{lib.stem}.ptxas.txt").read_text()
    usage, k, spills = {}, None, (0, 0)
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            k = key(entry.group(1))
            spills = (0, 0)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            spills = (int(spill.group(1)), int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used and k is not None:
            usage[k] = (int(used.group(1)), *spills)
    return usage


def sc_usage(ops) -> tuple:
    """(registers, spill store bytes, spill load bytes) of the window
    kernel in the report of ``ops``'s build."""
    return ptxas_usage(ops, ops.cuda_sc,
                       lambda e: "sc" if "sc_windows_kernel" in e
                       else None).get("sc")


def sc_shared_bytes(ops, a, half: int, stride: int, offset: int,
                    G: int) -> int:
    """A window block's dynamic shared bytes; checkouts before the staged
    kernel kept 512-output tiles of block partials only."""
    if hasattr(ops.cuda_sc, "launch_plan"):
        return ops.cuda_sc.launch_plan(a.shape[0], a.shape[1], half, stride,
                                       offset, G, a.device)["shared_bytes"]
    hb = half // stride
    return (512 + hb - 1) * 8 + (2 * 512 + 3 * hb - 1) * 4


def shared_bytes(ops, graph, msg_dtype) -> int:
    """A block's dynamic shared bytes; checkouts before the bf16 records
    kept (2n + Dm) float32 words for both instantiations."""
    if hasattr(ops.cuda_ldpc, "shared_bytes"):
        return ops.cuda_ldpc.shared_bytes(graph, msg_dtype)
    return (2 * graph.n + graph.D * graph.m) * 4


def pairs_of_turns(earlier_fn, current_fn, pairs: int, reps: int,
                   kernel: str | None) -> tuple[list, list]:
    """Per-pair device ms of each version, the order alternating: the
    kernel's per launch, or (``kernel`` None) the device busy time a
    call."""
    earlier, current = [], []
    for p in range(pairs):
        turns = [(earlier, earlier_fn), (current, current_fn)]
        for out, fn in (turns if p % 2 == 0 else turns[::-1]):
            out.append(S.device_ms(fn, reps, kernel) if kernel else
                       S.profile_busy_ms(fn, reps, rows=0))
    return earlier, current


def awgn_usage(ops) -> dict | None:
    """{regime kernel: (registers, spill store bytes, spill load bytes)} of
    the AWGN library of ``ops``, None for a checkout without it."""
    if not hasattr(ops, "cuda_awgn"):
        return None
    return ptxas_usage(ops, ops.cuda_awgn,
                       lambda e: next((k for k in ("rows", "stream")
                                       if f"awgn_{k}_kernel" in e), None))


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
    parser.add_argument("--msg", choices=sorted(MSG), default="f32",
                        help="the LDPC kernel's message types to time")
    parser.add_argument("--threads", type=int, choices=(256, 1024),
                        help="LDPC block size for both versions (default: "
                        "each version's block_threads_for)")
    parser.add_argument("--kernels",
                        choices=("all", "ldpc", "windows", "awgn"),
                        default="all", help="the rows to time")
    parser.add_argument("--tiles", default="",
                        help="comma-separated window tiles to sweep")
    args = parser.parse_args()
    card = S.card_line()
    print(f"card: {card}", flush=True)
    dev = S.require_cuda()
    old = load_earlier(args.checkout)
    if args.threads:
        for mod in (cuda_ldpc, old.ops.cuda_ldpc):
            mod.block_threads_for = lambda B, sms: args.threads
    ldpc = args.kernels in ("all", "ldpc")
    usage = {"earlier": ptxas_usage(old.ops),
             "current": ptxas_usage(current_ops)} if ldpc else {}
    sc_regs = {"earlier": sc_usage(old.ops), "current": sc_usage(current_ops)}
    tiles = [int(t) for t in args.tiles.split(",") if t]
    rows, sweeps = [], []

    def ldpc_row(label, rate, llrs, reps, trap_escape=False):
        llrs = llrs.contiguous()
        graph = ldpc_ops.graph_for(S.get_code(rate), dev)
        old_graph = old.ops.ldpc.graph_for(old.get_code(rate), dev)
        threads = cuda_ldpc.block_threads_for(llrs.shape[0],
                                              cuda_build.sm_count(dev))
        for dtype in MSG[args.msg]:
            bf16 = dtype == torch.bfloat16
            kw = {"trap_escape": trap_escape}
            if bf16:  # (checkouts before the bf16 kernel take no msg_dtype)
                kw["msg_dtype"] = dtype
            new = cuda_ldpc.decode_cuda(graph, llrs, **kw)
            ref = old.ops.cuda_ldpc.decode_cuda(old_graph, llrs, **kw)
            torch.cuda.synchronize()
            S.require(all(torch.equal(x, y) for x, y in zip(new, ref)),
                      f"the two LDPC kernels disagree on {label} "
                      f"({dtype})")
            bound_ms, by, passes = S.ldpc_run_bound(graph, llrs, trap_escape,
                                                    dtype)
            earlier, current = pairs_of_turns(
                lambda: old.ops.cuda_ldpc.decode_cuda(old_graph, llrs, **kw),
                lambda: cuda_ldpc.decode_cuda(graph, llrs, **kw), args.pairs,
                reps, "ldpc_minsum_kernel")
            rows.append(row(
                "ldpc_minsum_bf16" if bf16 else "ldpc_minsum",
                label + (", trap_escape" if trap_escape else ""),
                llrs.shape[0], earlier, current, bound_ms, by,
                mean_iterations_run=passes, threads=threads,
                registers_spills={k: u.get((threads, bf16))
                                  for k, u in usage.items()},
                shared_bytes={
                    "earlier": shared_bytes(old.ops, old_graph, dtype),
                    "current": shared_bytes(current_ops, graph, dtype)}))

    def sc_row(label, a, stride, offset, G, reps, half=S.HALF):
        new = cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
        ref = old.ops.cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
        torch.cuda.synchronize()
        S.require(all(bool(torch.isclose(x, y, rtol=S.WINDOW_RTOL,
                                         atol=S.WINDOW_ATOL).all())
                      for x, y in zip(new, ref)),
                  f"the two window kernels disagree on {label}")
        bound_ms, by = yardstick.sc_bound(a.shape[0], half, stride, G)
        earlier, current = pairs_of_turns(
            lambda: old.ops.cuda_sc.sc_windows_cuda(a, half, stride, offset,
                                                    G),
            lambda: cuda_sc.sc_windows_cuda(a, half, stride, offset, G),
            args.pairs, reps, "sc_windows_kernel")
        rows.append(row(
            "sc_windows", f"{label}, half {half}", a.shape[0], earlier,
            current, bound_ms, by, registers_spills=sc_regs,
            shared_bytes={who: sc_shared_bytes(ops, a, half, stride, offset,
                                               G)
                          for who, ops in (("earlier", old.ops),
                                           ("current", current_ops))},
            plan=cuda_sc.launch_plan(a.shape[0], a.shape[1], half, stride,
                                     offset, G, dev)))
        if tiles:
            tile_sweep(label, a, half, stride, offset, G, reps, ref)

    def tile_sweep(label, a, half, stride, offset, G, reps, ref):
        """Device ms of the current kernel at each swept tile (mean of a
        forward and a backward pass over the tiles)."""
        pick = cuda_sc.tile_for(a.shape[0], G, half, stride,
                                cuda_build.sm_count(dev))
        cand = sorted(set(tiles) | {pick})
        times = {t: [] for t in cand}
        for order in (cand, cand[::-1]):
            for t in order:
                with mock.patch.object(cuda_sc, "tile_for",
                                       lambda *_, t=t: t):
                    out = cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
                    S.require(all(bool(torch.isclose(
                        x, y, rtol=S.WINDOW_RTOL, atol=S.WINDOW_ATOL).all())
                        for x, y in zip(out, ref)),
                        f"tile {t} disagrees on {label}")
                    times[t].append(S.device_ms(
                        lambda: cuda_sc.sc_windows_cuda(a, half, stride,
                                                        offset, G),
                        reps, "sc_windows_kernel"))
        sweeps.append({"shape": f"{label}, half {half}", "B": a.shape[0],
                       "rule": pick, **{str(t): statistics.mean(v)
                                        for t, v in times.items()}})
        print(f"tile sweep [{label}, half {half}, B={a.shape[0]}; rule "
              f"picks {pick}]: " + ", ".join(
                  f"{t}: {statistics.mean(v)!r} ms" for t, v in
                  times.items()) + f" on {card}", flush=True)

    def noise_signal(B, T, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return SC.analytic_signal(torch.randn((B, T), generator=g,
                                              device=dev))

    # LDPC: the presynced path's 17 dB LLRs, the waterfall batch, a Cox
    # buffer's LLRs, the chirp cell's R1/4 LLRs.
    deint = S.phase_main_path(dev)[1] if ldpc else None
    _, tx = S.cox_tx(dev, 10)
    rx = S.noisy_buffers(tx, torch.Generator(device=dev).manual_seed(20),
                         1)[0]
    if ldpc:
        ldpc_row("R1/2 17 dB main path", S.RATE, deint, 20)
        wf = torch.from_numpy(S.waterfall_llrs(S.RATE, 0.62,
                                               S.BATCH)).to(dev)
        ldpc_row("R1/2 waterfall sigma=0.62", S.RATE, wf, 5)
        r14 = torch.from_numpy(S.waterfall_llrs(CodeRate.R1_4, 1.1,
                                                4096)).to(dev)
        ldpc_row("R1/4 waterfall sigma=1.1", CodeRate.R1_4, r14, 5, True)
        det = SC.detect_preamble(S.COX_CFG, rx)
        pipe = S.P.pipeline_for(S.COX_CFG, S.MOD, S.RATE, 1, dev)
        ldpc_row("R1/2 17 dB Cox buffer", S.RATE, pipe.deinterleave(
            SC.demodulate_detected(S.COX_CFG, S.MOD, rx, det)), 20)
        _, ctx = S.chirp_tx(dev, 30)
        crx = S.noisy_buffers(ctx,
                              torch.Generator(device=dev).manual_seed(35),
                              1, S.CHIRP_SNR_DB)[0]
        ldpc_row("R1/4 5 dB chirp cell", S.CHIRP_RATE, S.chirp_llrs(crx), 20)
        _, ok14, _ = cuda_ldpc.decode_cuda(
            ldpc_ops.graph_for(S.get_code(CodeRate.R1_4), dev), r14)
        lane = int(torch.nonzero(~ok14)[0])
        ldpc_row("R1/4 sigma=1.1, one unconverged codeword", CodeRate.R1_4,
                 r14[lane:lane + 1], 20, True)
        _, okwf, _ = cuda_ldpc.decode_cuda(
            ldpc_ops.graph_for(S.get_code(S.RATE), dev), wf)
        lane = int(torch.nonzero(~okwf)[0])
        ldpc_row("R1/2 sigma=0.62, one unconverged codeword", S.RATE,
                 wf[lane:lane + 1], 20)

    if args.kernels in ("all", "windows"):
        # The Cox buffer's analytic signal at strides 8 and 1; the NVIS
        # plan's half 512; the engine's search view; the whole-frame
        # searches of test_sync_robustness.
        a = SC.analytic_signal(rx)
        for stride, (st, off, G) in S.window_shapes(S.COX_T).items():
            sc_row(f"Cox buffer, T={S.COX_T}, stride {stride}, G={G}", a, st,
                   off, G, 50 if stride == 8 else 10)
        T = 15080
        G = SC.search_grid_size(S.NVIS_CFG, T)
        sc_row(f"NVIS-sized noise, T={T}, stride 8, G={G}",
               noise_signal(512, T, 41), 8, S.NVIS_CFG.cyclic_prefix, G, 50,
               half=S.NVIS_CFG.fft_size // 2)
        for B, T, label in ((1, ModemEngine.ACQ_VIEW_CAP,
                             "engine search view"),
                            (10, 39936, "test_sync_robustness searches")):
            G = SC.search_grid_size(S.COX_CFG, T)
            sc_row(f"{label} (noise), T={T}, stride 8, G={G}",
                   noise_signal(B, T, 42 + B), 8, S.CP, G, 50)

    if args.kernels in ("all", "awgn"):
        from projectultra_tpu_torch.ops import cuda_awgn
        from projectultra_tpu_torch.sim import watterson as W
        try:
            importlib.import_module(f"{EARLIER}.ops.cuda_awgn")
        except ImportError:
            pass
        regs = {"earlier": awgn_usage(old.ops),
                "current": awgn_usage(current_ops)}
        g = torch.Generator(device=dev).manual_seed(60)
        for label, B, T, reps in (("presynced cells", S.BATCH, 7332, 10),
                                  ("Cox cell", 2048, S.COX_T, 20),
                                  ("acquired cell", 2048, S.CHIRP_T, 10),
                                  ("engine view", 1, 262144, 50)):
            x = 0.3 * torch.randn((B, T), generator=g, device=dev)
            z = torch.randn((B, T), generator=g, device=dev)
            ref, new = S.pair_outputs(
                lambda: old.sim.watterson.add_noise_with(x, S.SNR_DB, z),
                lambda: W.add_noise_with(x, S.SNR_DB, z))
            S.require_awgn_close(f"{label}, earlier against current", x,
                                 new, ref)
            del ref, new
            bound_ms, by = S.awgn_bound(B, T)
            earlier, current = pairs_of_turns(
                lambda: old.sim.watterson.add_noise_with(x, S.SNR_DB, z),
                lambda: W.add_noise_with(x, S.SNR_DB, z), args.pairs, reps,
                None)
            plan = cuda_awgn.launch_plan(B, T)
            extra = {}
            if plan["regime"] == "cluster":
                # the design's A/B: the same rows streamed twice
                stream = cuda_awgn.regime_plan("stream", B, T)
                with mock.patch.object(cuda_awgn, "launch_plan",
                                       lambda B, T: stream):
                    S.require_awgn_close(f"{label}, stream regime", x,
                                         W.add_noise_with(x, S.SNR_DB, z),
                                         W.add_noise_with_plain(
                                             x, S.SNR_DB, z))
                    extra["stream_regime_ms"] = statistics.median(
                        S.profile_busy_ms(
                            lambda: W.add_noise_with(x, S.SNR_DB, z),
                            reps, rows=0) for _ in range(args.pairs))
            rows.append(row(
                "awgn_active", f"{label}, T={T}", B, earlier, current,
                bound_ms, by, bound4_ms=S.awgn_bound(B, T, 4)[0], **extra,
                registers_spills={who: u and u.get(
                    "stream" if plan["regime"] == "stream" else "rows")
                    for who, u in regs.items()},
                shared_bytes={"earlier": None,
                              "current": plan["shared_bytes"]},
                awgn_plan=plan))
            del x, z
            torch.cuda.empty_cache()

    for r in rows:
        regs = "".join(
            f", {who}: {u[0]} registers, spills {u[1]}/{u[2]} B, "
            f"{r['shared_bytes'][who]} shared B"
            for who, u in r.get("registers_spills", {}).items() if u)
        if "awgn_plan" in r:
            regs += (", current plan: {regime}, {parts} parts of {slice} "
                     "samples, {threads} threads".format(**r["awgn_plan"])
                     + f", 4-pass bound {r['bound4_ms']!r} ms")
            if "stream_regime_ms" in r:
                regs += (f", the stream regime (4 passes) at this shape "
                         f"{r['stream_regime_ms']!r} ms")
        if "plan" in r:
            regs += (", current plan: {tile} outputs an item, {items} items, "
                     "{blocks} blocks, {stages} stages".format(**r["plan"]))
        print(f"{r['kernel']} [{r['shape']}, B={r['B']}{regs}]: earlier "
              f"{r['earlier_ms']!r} ms, current {r['ms']!r} ms (medians of "
              f"{r['pairs']} pairs; current/earlier per pair "
              f"{r['ratio_min']!r}-{r['ratio_max']!r}, current faster in "
              f"{r['current_won']} of {r['pairs']}), bound {r['bound_ms']!r} "
              f"ms ({r['bound_by']}), share of bound "
              f"{r['bound_ms'] / r['earlier_ms']!r} -> "
              f"{r['bound_ms'] / r['ms']!r} on {card}", flush=True)
    print(json.dumps({"card": card, "rows": rows, "tile_sweeps": sweeps}),
          flush=True)


if __name__ == "__main__":
    main()
