#!/usr/bin/env python3
"""Multi-process sweep dry run on the PyTorch/CUDA port: 2 ranks == 1
(``tools/dcn_sweep.py`` runs the same check on the JAX package).

Launcher (no --rank): computes the world-1 reference counts of
``parallel.dcn.acq_sweep_counts`` in this process, then starts two worker
processes that join one ``torch.distributed`` group over
``tcp://127.0.0.1:<free port>`` and run the SAME sweep on half the frames
each, and checks that every count is identical.  On the card the world-1
reference runs over NCCL; two workers on one card share it over gloo (NCCL
refuses two ranks on one GPU), two cards give NCCL; ``--cpu`` runs gloo on
the CPU.

    python3 tools/torch_dcn_sweep.py [--frames 16] [--snr 5] [--cpu]
    python3 tools/torch_dcn_sweep.py --rank N --world M \\
        --init-method tcp://127.0.0.1:PORT [--cpu]               # worker
"""

import argparse
import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def worker(args, device):
    from projectultra_tpu_torch.parallel import dcn
    from projectultra_tpu_torch.parallel.mesh import frame_mesh
    with frame_mesh(args.world, args.rank, args.init_method, device) as mesh:
        counts = dcn.acq_sweep_counts(B=args.frames, snr_db=args.snr,
                                      mesh=mesh)
        print(f"WORKER_RESULT {mesh.backend} " + json.dumps(counts),
              flush=True)
    return 0


def launcher(args, device):
    from projectultra_tpu_torch.parallel import dcn
    from projectultra_tpu_torch.parallel.mesh import frame_mesh
    with frame_mesh(device=device) as mesh:
        ref = dcn.acq_sweep_counts(B=args.frames, snr_db=args.snr, mesh=mesh)
        print(f"world 1 ({mesh.backend}, {mesh.device}) reference: {ref}",
              flush=True)
    if ref["decoded"] != args.frames:
        print(f"the reference sweep must fully decode, got {ref}")
        return 1

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = [sys.executable, os.path.abspath(__file__),
            "--frames", str(args.frames), "--snr", str(args.snr),
            "--world", "2", "--init-method", f"tcp://127.0.0.1:{port}"] \
        + (["--cpu"] if args.cpu else [])
    procs = [subprocess.Popen(base + ["--rank", str(i)],
                              stdout=subprocess.PIPE, text=True)
             for i in range(2)]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=args.timeout)
            if p.returncode != 0:
                print(f"worker failed rc={p.returncode}\n{out}")
                return 1
            for line in out.splitlines():
                if line.startswith("WORKER_RESULT "):
                    _, backend, counts = line.split(" ", 2)
                    results.append((backend, json.loads(counts)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"world 2 workers (backend, counts): {results}")
    ok = len(results) == 2 and all(r == ref for _, r in results)
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--snr", type=float, default=5.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (gloo) instead of the card")
    args = ap.parse_args()
    device = "cpu" if args.cpu else None
    if args.rank is not None:
        return worker(args, device)
    return launcher(args, device)


if __name__ == "__main__":
    sys.exit(main())
