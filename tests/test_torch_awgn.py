"""The harness AWGN channel's plain version and its kernel's wrapper
(``sim/watterson.add_noise_with_plain``, ``ops/cuda_awgn.py``) on the CPU.

* ``launch_plan`` holds a row in one block's shared memory where it fits
  (the presynced and Cox cells' rows), over a thread-block cluster where a
  cluster holds it (the acquired cell's), and streams longer rows (the
  engine's and the tools' 1-D buffers) twice; every plan's slices are
  multiples of 4 samples, cover the row and leave no block empty;
* the wrapper refuses float64, complex and CPU tensors, noise of another
  shape and a per-frame SNR away from the samples' device before any
  library is loaded, and takes the SNR as the plain version makes it;
* the plain version's edge cases, which the kernel is held to on the card
  (``tests/test_torch_cuda.py``): an all-zero row gets ``samples + 0 *
  noise``, NaN and sub-threshold samples are inactive, an infinite one is
  active; off the card ``add_noise_with`` is the plain version.
"""

import numpy as np
import pytest
import torch

from projectultra_tpu_torch.ops import cuda_awgn
from projectultra_tpu_torch.sim import watterson as TW

torch.set_num_threads(2)


@pytest.mark.parametrize("T,regime,parts", [
    (7332, "row", 1),          # the presynced cells
    (18856, "row", 1),         # the Cox cell
    (83808, "cluster", 8),     # the acquired cell
    (196608, "cluster", 8),    # the longest a cluster holds
    (262144, "stream", 32),    # the engine's search views
    (2000000, "stream", 245),  # a tool's long buffer
])
def test_launch_plan_picks_the_regime_from_the_row(T, regime, parts):
    plan = cuda_awgn.launch_plan(2048, T)
    assert (plan["regime"], plan["parts"]) == (regime, parts)
    assert plan["passes"] == (4 if regime == "stream" else 3)


@pytest.mark.parametrize("T", [1, 3, 4, 7, 33, 7332, 18856, 24576, 24577,
                               83808, 196608, 196609, 262144, 2000003])
def test_launch_plan_slices_cover_the_row(T):
    plan = cuda_awgn.launch_plan(3, T)
    _assert_plan_covers(plan, T)


@pytest.mark.parametrize("regime", ["row", "cluster", "stream"])
@pytest.mark.parametrize("T", [20000, 98305])
def test_regime_plans_cover_the_row(regime, T):
    """The plans the card tests and the A/B tool force at row lengths more
    than one regime can take."""
    plan = cuda_awgn.regime_plan(regime, 3, T)
    assert plan["regime"] == regime
    if plan["slice"] <= cuda_awgn.MAX_SLICE or regime == "stream":
        _assert_plan_covers(plan, T)


def _assert_plan_covers(plan: dict, T: int) -> None:
    parts, slice_ = plan["parts"], plan["slice"]
    assert slice_ % 4 == 0 and (parts - 1) * slice_ < T <= parts * slice_
    assert plan["threads"] % cuda_awgn.WARP == 0
    if plan["regime"] == "stream":
        assert slice_ <= cuda_awgn.STREAM_SLICE
        assert plan["items"] == 3 * parts and plan["shared_bytes"] == 0
    else:
        assert slice_ <= cuda_awgn.MAX_SLICE
        assert parts <= cuda_awgn.MAX_PARTS
        assert plan["threads"] <= cuda_awgn.MAX_THREADS
        assert plan["blocks"] == 3 * parts
        assert plan["shared_bytes"] == 4 * slice_
        assert parts == (1 if plan["regime"] == "row"
                         else cuda_awgn.MAX_PARTS)
        # a power of two of threads, each staging about VEC_PER_THREAD
        # 16-byte runs
        threads = plan["threads"]
        assert threads & (threads - 1) == 0
        assert threads == cuda_awgn.MAX_THREADS or threads == 32 or \
            threads // 2 * cuda_awgn.VEC_PER_THREAD < slice_ // 4 \
            <= threads * cuda_awgn.VEC_PER_THREAD


@pytest.mark.parametrize("bad,match", [
    (lambda x, z: (x.double(), 17.0, z.double()), "float32"),
    (lambda x, z: (x.to(torch.complex64), 17.0, z.to(torch.complex64)),
     "float32"),
    (lambda x, z: (x, 17.0, z), "CUDA"),
    (lambda x, z: (x, 17.0, z[:, :-1]), "noise must be"),
    (lambda x, z: (x[0, 0], 17.0, z[0, 0]), "sample axis"),
])
def test_wrapper_checks_before_loading(bad, match, monkeypatch):
    monkeypatch.setattr(cuda_awgn.LIBRARY, "_lib", None)
    monkeypatch.setattr(cuda_awgn.LIBRARY, "load", lambda: pytest.fail(
        "the library was loaded"))
    x, z = torch.ones((3, 8)), torch.zeros((3, 8))
    with pytest.raises(ValueError, match=match):
        cuda_awgn.add_noise_cuda(*bad(x, z))


@pytest.mark.parametrize("snr_db", [17.0, 5, np.float32(-3.25),
                                    torch.tensor(17.0), np.array(2.5)])
def test_host_snr_is_the_reciprocal_pytorch_multiplies_by(snr_db):
    """A host SNR travels by value as float32(1 / snr_lin), snr_lin by the
    plain version's own expression: PyTorch divides a CUDA tensor by a CPU
    scalar as a product with that reciprocal."""
    snr, step, inv = cuda_awgn._snr_arg(snr_db, torch.Size([4]),
                                        torch.device("cpu"))
    lin = np.float32((10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32)
                               / 10.0)).item())
    assert snr is None and step == 0
    assert inv == float(np.float32(1.0) / lin)


def test_per_frame_snr_is_broadcast_to_the_rows():
    snr_db = torch.tensor([[0.0], [3.0]])
    per_row, step, _ = cuda_awgn._snr_arg(snr_db, torch.Size([2, 3]),
                                          torch.device("cpu"))
    want = (10.0 ** (snr_db / 10.0)).expand(2, 3).reshape(-1)
    assert torch.equal(per_row, want) and step == per_row.stride(0) == 1
    one, step, _ = cuda_awgn._snr_arg(torch.tensor([4.0]), torch.Size([5]),
                                      torch.device("cpu"))
    assert one.shape == (5,) and step == 0
    with pytest.raises(ValueError, match="must be on"):
        cuda_awgn._snr_arg(torch.tensor([1.0, 2.0]), torch.Size([2]),
                           torch.device("meta"))


def _row(kind: str) -> torch.Tensor:
    """A 2-row batch whose row 0 is ``kind``; row 1 is an ordinary frame."""
    g = torch.Generator().manual_seed(7)
    x = 0.3 * torch.randn((2, 64), generator=g)
    if kind == "zeros":
        x[0] = 0.0
    elif kind == "sub-threshold":
        x[0] = torch.full((64,), float(np.float32(1e-6))) * torch.sign(
            torch.randn(64, generator=g))
    elif kind in ("nan", "inf"):
        x[0, 10] = float(kind)
    return x


@pytest.mark.parametrize("kind", ["zeros", "sub-threshold", "nan", "inf"])
def test_plain_channel_edge_rows(kind):
    x = _row(kind)
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    y = TW.add_noise_with_plain(x, 10.0, z)
    rest = 0.3 * torch.randn((2, 64), generator=torch.Generator().manual_seed(
        7))[0]
    if kind in ("zeros", "sub-threshold"):
        # nothing active: power 0 / 1, std 0, the row comes back unchanged
        assert torch.equal(y[0], x[0] + 0.0 * z[0])
    elif kind == "nan":
        # the NaN sample is inactive: the power is the others' and only its
        # own output is NaN
        keep = torch.arange(64) != 10
        power = (rest[keep] ** 2).sum() / 63
        std = torch.sqrt(power / np.float32(10.0))
        assert torch.isnan(y[0, 10]) and torch.isfinite(y[0, keep]).all()
        torch.testing.assert_close(y[0, keep], x[0, keep] + std * z[0, keep],
                                   rtol=1e-6, atol=1e-7)
    else:
        # an infinite sample is active: its row's power and std are
        # infinite, every output of the row non-finite
        assert not torch.isfinite(y[0]).any()
    assert torch.isfinite(y[1]).all()


def test_add_noise_with_off_the_card_is_the_plain_version():
    x = _row("nan")
    z = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    before = cuda_awgn.launches
    for snr in (17.0, torch.tensor([3.0, 9.0])):
        got = TW.add_noise_with(x, snr, z)
        want = TW.add_noise_with_plain(x, snr, z)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert cuda_awgn.launches == before
