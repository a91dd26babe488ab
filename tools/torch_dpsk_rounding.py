#!/usr/bin/env python3
"""Which rounding of the complex product makes the DPSK score kernel
bit-equal to PyTorch's own CUDA operators on this card.

    python3 tools/torch_dpsk_rounding.py

``csrc/dpsk_score.cu`` computes each differential's complex product
(a*c - b*d, a*d + b*c) with the two fused multiply-adds that PyTorch's
CUDA build makes of c10::complex's product.  This tool builds the kernel
once for each of the five ways to round that product -- unfused, and each
pair of fused multiply-adds -- from the source in the checkout (text
substitution into copies under the git-ignored build directory) and, on
``chip_smoke.py``'s DPSK ``medium`` (B = 256) and ``robust`` (B = 64)
buffers, counts the scores that differ from ``dpsk_score_plain``'s on the
same card, their largest difference, and the ``find_preamble`` outputs
(found, data_start, cfo, ipo, prev) that differ from the search through
the plain score.  The source's own form must be among those with no
difference.  The last line is a JSON object with every row.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from projectultra_tpu_torch.ops import cuda_build, cuda_dpsk  # noqa: E402
from projectultra_tpu_torch.ops import dpsk_score as DS  # noqa: E402

SOURCE_FORM = ("  const float re = __fmaf_rn(cur.x, c, -(cur.y * d));\n"
               "  const float im = __fmaf_rn(cur.x, d, cur.y * c);\n")
FORMS = {
    "fma(a,c,-bd) fma(a,d,bc)": SOURCE_FORM,
    "unfused": ("  const float re = cur.x * c - cur.y * d;\n"
                "  const float im = cur.x * d + cur.y * c;\n"),
    "fma(-b,d,ac) fma(b,c,ad)": (
        "  const float re = __fmaf_rn(-cur.y, d, cur.x * c);\n"
        "  const float im = __fmaf_rn(cur.y, c, cur.x * d);\n"),
    "fma(a,c,-bd) fma(b,c,ad)": (
        "  const float re = __fmaf_rn(cur.x, c, -(cur.y * d));\n"
        "  const float im = __fmaf_rn(cur.y, c, cur.x * d);\n"),
    "fma(-b,d,ac) fma(a,d,bc)": (
        "  const float re = __fmaf_rn(-cur.y, d, cur.x * c);\n"
        "  const float im = __fmaf_rn(cur.x, d, cur.y * c);\n"),
}


def buffers(dev: torch.device) -> list:
    """(preset, cfg, rx, score inputs) of chip_smoke.phase_dpsk's first
    buffer at each preset."""
    out = []
    for i, (preset, snr, B) in enumerate(CS.DPSK_CASES):
        cfg = getattr(CS.DP, preset)()
        g = torch.Generator(device=dev).manual_seed(80 + i)
        info = CS.random_info(g, B, CS.get_code(CS.DPSK_RATE).k)
        rx = CS.W.add_noise_active(CS.dpsk_tx(cfg, info), snr, g)
        out.append((preset, cfg, rx, CS.score_inputs(cfg, rx)))
    return out


def main() -> int:
    dev = CS.require_cuda()
    card = CS.card_line()
    print(f"card: {card}", flush=True)
    source = cuda_dpsk.SOURCE.read_text()
    if SOURCE_FORM not in source:
        raise SystemExit("the source's product form is not SOURCE_FORM")
    cases = buffers(dev)
    rows = []
    for name, form in FORMS.items():
        variant = cuda_build.BUILD_DIR / f"dpsk_score_form{len(rows)}.cu"
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        variant.write_text(source.replace(SOURCE_FORM, form))
        cuda_dpsk.LIBRARY = cuda_build.KernelLibrary(
            "dpsk_score", variant, cuda_dpsk.FLAGS, cuda_dpsk._bind)
        for preset, cfg, rx, (corr, L, n_sym, O) in cases:
            args = (corr, L, n_sym, O, CS.DP.EXPECTED_SIGNS,
                    CS.DP.MIN_SYMBOL_ENERGY)
            got = cuda_dpsk.dpsk_score_cuda(*args)
            want = DS.dpsk_score_plain(*args)
            found = CS.DP.find_preamble(cfg, rx)
            ref = CS.plain_score(CS.DP.find_preamble)(cfg, rx)
            torch.cuda.synchronize()
            row = {"form": name, "preset": preset, "scores": got.numel(),
                   "differing": int((got != want).sum()),
                   "max_abs_diff": float((got - want).abs().max()),
                   "find_preamble_equal": [bool(torch.equal(a, b))
                                           for a, b in zip(found, ref)],
                   "lanes_with_another_cfo": int((found[2] != ref[2]).sum())}
            rows.append(row)
            print(f"{name} at {preset}: {row['differing']} of "
                  f"{row['scores']} scores differ from the plain version's "
                  f"(max {row['max_abs_diff']!r}); find_preamble outputs "
                  f"equal {row['find_preamble_equal']}, lanes with another "
                  f"CFO {row['lanes_with_another_cfo']} ({card})",
                  flush=True)
    own = [r for r in rows if r["form"] == next(iter(FORMS))]
    ok = all(r["differing"] == 0 for r in own)
    print(json.dumps({"card": card, "source_form_exact": ok, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
