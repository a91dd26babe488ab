#!/usr/bin/env python3
"""Replays the noisy streams that ``tools/torch_parity_curves.py
--streams DIR`` saved for a point below the reference through the JAX
package's single-stream receiver and the port's, both on the CPU.

A point the port decodes below the reference's count is a port fault
only where the JAX receiver, on the same noisy streams, decodes frames
the port misses; where JAX misses the same frames, the shortfall is the
noise realization's (a reference behaviour).

    python3 tests/replay_parity_streams.py DIR

Prints, per saved stream (``point{index}_seed{seed}.npy``), the frames
each receiver delivered with every codeword ok, and the totals per point;
exits 1 where the two receivers differ.
"""

import collections
import importlib.util
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    from projectultra_tpu.config import CodeRate as JCR
    from projectultra_tpu.parallel import sweep as JS
    from projectultra_tpu_torch.parallel import sweep as TS
    from test_torch_sweep import _jax_receive

    spec = importlib.util.spec_from_file_location(
        "torch_parity_curves", HERE.parent / "tools" / "torch_parity_curves.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    totals = collections.defaultdict(lambda: [0, 0, 0])
    differ = False
    for path in sorted(pathlib.Path(argv[0]).glob("point*_seed*.npy")):
        index, seed = map(int, re.findall(r"\d+", path.stem))
        wf, snr, cfo, chan, rate, frames = tool.POINTS[index]
        jp = JS.SweepPoint(wf, snr, cfo, chan, rate=JCR[rate.upper()],
                           frames=frames)
        noisy = np.load(path)
        jax_got, _ = _jax_receive(jp, noisy)
        _, port_got = TS.receive_stream(
            tool.sweep_point(*tool.POINTS[index]), noisy,
            torch.device("cpu"))
        sent = {f"stream frame {i:02d}" for i in range(frames)}
        print(f"point {index} seed {seed}: JAX {len(jax_got)}/{frames} "
              f"(missed {sorted(sent - jax_got)}), port "
              f"{len(port_got)}/{frames} (missed {sorted(sent - port_got)})",
              flush=True)
        t = totals[index]
        t[0] += len(jax_got)
        t[1] += len(port_got)
        t[2] += frames
        differ |= jax_got != port_got
    for index, (j, p, n) in totals.items():
        print(f"point {index} {tool.POINTS[index]}: JAX {j}/{n}, port {p}/{n}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
