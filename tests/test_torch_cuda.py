"""The hand-written CUDA LDPC kernel against the plain PyTorch decoder.

These tests need a CUDA card (Hopper: the kernel is built for sm_90a) and
skip without one.  On the card:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Bits, ok flags, iteration counts and total LLRs must be equal on every
lane: golden codewords of all five rates, noisy waterfall batches,
trap_escape, max_iters 0 and 1, and the whole frame pipeline on the card
against the same pipeline on the CPU.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from projectultra_tpu.config import CodeRate, Modulation  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402

from projectultra_tpu_torch.ofdm import pipeline as TP  # noqa: E402
from projectultra_tpu_torch.ops import cuda_ldpc  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as T  # noqa: E402
from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402

pytestmark = pytest.mark.cuda

NAMES = {CodeRate.R1_4: "R1_4", CodeRate.R1_2: "R1_2", CodeRate.R2_3: "R2_3",
         CodeRate.R3_4: "R3_4", CodeRate.R5_6: "R5_6"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _golden_llr(golden_dir, rate):
    fields = {}
    with open(os.path.join(golden_dir, f"golden_ldpc_{NAMES[rate]}.txt")) as f:
        for line in f:
            toks = line.split()
            fields.update(zip(toks[::2], toks[1::2]))
    coded = np.unpackbits(np.frombuffer(bytes.fromhex(fields["coded"]),
                                        np.uint8))[:648]
    return (4.0 * (1.0 - 2.0 * coded.astype(np.float32)))[None]


def _noisy_llr(rate, sigma, B):
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(1234)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.int64)
    cw = np.concatenate([info, (info @ code.h_dense.T.astype(np.int64)) & 1], 1)
    y = (1.0 - 2.0 * cw.astype(np.float32)) \
        + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    return (2.0 * y / (sigma * sigma)).astype(np.float32)


def _assert_kernel_equals_plain(rate, llr, dev, **kw):
    graph = T.graph_for(ldpc.get_code(rate), dev)
    x = torch.from_numpy(llr).to(dev)
    before = cuda_ldpc.launches
    got = cuda_ldpc.decode_cuda(graph, x, **kw)
    assert cuda_ldpc.launches > before
    want = T.decode_plain(graph, x, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("rate", list(NAMES))
def test_kernel_equals_plain_on_golden(dev, golden_dir, rate):
    _, ok, iters = _assert_kernel_equals_plain(
        rate, _golden_llr(golden_dir, rate), dev)
    assert bool(ok.all())


@pytest.mark.parametrize("rate,sigma", [(CodeRate.R1_2, 0.62),
                                        (CodeRate.R1_4, 1.1),
                                        (CodeRate.R5_6, 0.5)])
def test_kernel_equals_plain_under_noise(dev, rate, sigma):
    _, ok, iters = _assert_kernel_equals_plain(
        rate, _noisy_llr(rate, sigma, 512), dev)
    assert 0.0 < float(ok.float().mean()) < 1.0
    assert int(iters.max()) == 50


@pytest.mark.parametrize("max_iters", [0, 1, 2])
def test_kernel_equals_plain_at_few_iterations(dev, max_iters):
    _assert_kernel_equals_plain(CodeRate.R1_2,
                                _noisy_llr(CodeRate.R1_2, 0.62, 256), dev,
                                max_iters=max_iters)


def test_kernel_trap_escape_equals_plain(dev):
    _assert_kernel_equals_plain(CodeRate.R1_2,
                                _noisy_llr(CodeRate.R1_2, 0.62, 256), dev,
                                max_iters=6, trap_escape=True)


def test_decode_on_cuda_goes_through_the_kernel(dev):
    code = ldpc.get_code(CodeRate.R1_2)
    x = torch.from_numpy(_noisy_llr(CodeRate.R1_2, 0.62, 64)).to(dev)
    before = cuda_ldpc.launches
    bits, ok, iters = T.decode(code, x)
    assert cuda_ldpc.launches == before + 1
    ref = T.decode(code, x.cpu())
    for a, b in zip((bits, ok, iters), ref):
        assert torch.equal(a.cpu(), b)


def test_kernel_wrapper_checks_its_inputs(dev):
    graph = T.graph_for(ldpc.get_code(CodeRate.R1_2), dev)
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((4, 648), dtype=torch.float64,
                                            device=dev), 50)
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((4, 640), device=dev), 50)
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((648, 4), device=dev).T, 50)


def test_pipeline_on_the_card_equals_the_cpu(dev):
    cfg = TP.chirp_ofdm_config()
    code = ldpc.get_code(CodeRate.R1_2)
    g = torch.Generator().manual_seed(7)
    info = torch.randint(0, 2, (64, code.k), generator=g, dtype=torch.uint8)
    tx = TP.tx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, info)
    rx = TW.add_noise_active(tx, 3.0, g)
    cpu = TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, rx)
    gpu = TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, rx.to(dev))
    # The demodulator's float32 products differ by ulps between the two
    # devices; at 3 dB (some lanes need a second iteration) a lane could
    # flip, so compare decoded frames.
    both = cpu[1] & gpu[1].cpu()
    assert float(both.float().mean()) > 0.9
    assert torch.equal(cpu[0][both], gpu[0].cpu()[both])
    assert torch.equal(gpu[0].cpu()[gpu[1].cpu()], info[gpu[1].cpu()])


def test_main_path_never_synchronises(dev):
    """tx_frame -> add_noise_active -> rx_frame enqueue without a single
    host-device synchronisation once the per-device tables exist."""
    cfg = TP.chirp_ofdm_config()
    code = ldpc.get_code(CodeRate.R1_2)
    g = torch.Generator(device=dev).manual_seed(3)
    info = torch.randint(0, 2, (256, code.k), generator=g, device=dev,
                         dtype=torch.uint8)

    def step():
        tx = TP.tx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, info)
        rx = TW.add_noise_active(tx, 17.0, g)
        return TP.rx_frame(cfg, Modulation.DQPSK, CodeRate.R1_2, rx)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok, _ = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok.all()) and torch.equal(out, info)
