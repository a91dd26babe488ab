"""LDPC encode/decode of the PyTorch port against the JAX package.

The port's plain decoder must equal ``ops/ldpc.decode`` (float32 messages)
in bits, ok flags and iteration counts on every lane: on the reference's
golden hard-input codewords of all five rates and on noisy waterfall
batches (the inputs of tests/test_pallas_ldpc.py), with trap_escape, and
at max_iters 0 and 1.  Against the Pallas kernel in interpret mode, ok
flags and iteration counts are equal and bits equal on the decoded lanes,
as tests/test_pallas_ldpc.py holds that kernel.
"""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ops import ldpc as J  # noqa: E402
from projectultra_tpu.ops.pallas_ldpc import decode_pallas  # noqa: E402

from projectultra_tpu_torch.ops import cuda_ldpc  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as T  # noqa: E402

NAMES = {CodeRate.R1_4: "R1_4", CodeRate.R1_2: "R1_2", CodeRate.R2_3: "R2_3",
         CodeRate.R3_4: "R3_4", CodeRate.R5_6: "R5_6"}
RATES = list(NAMES)


def _golden_llr(golden_dir, rate):
    fields = {}
    with open(os.path.join(golden_dir, f"golden_ldpc_{NAMES[rate]}.txt")) as f:
        for line in f:
            toks = line.split()
            fields.update(zip(toks[::2], toks[1::2]))
    code = ldpc.get_code(rate)
    coded = np.unpackbits(np.frombuffer(bytes.fromhex(fields["coded"]),
                                        np.uint8))[:code.n]
    return (4.0 * (1.0 - 2.0 * coded.astype(np.float32)))[None]


def _noisy_llr(rate, sigma, B=24):
    """The waterfall batch of tests/test_pallas_ldpc.py."""
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(1234)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.uint8)
    cw = np.stack([ldpc.encode_block_np(code, info[b]) for b in range(B)])
    y = (1.0 - 2.0 * cw.astype(np.float32)) \
        + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    return (2.0 * y / (sigma * sigma)).astype(np.float32)


def _assert_same(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("rate", RATES)
def test_encode_matches_jax(rate):
    code = ldpc.get_code(rate)
    info = np.random.default_rng(int(rate)).integers(
        0, 2, size=(8, code.k)).astype(np.float32)
    ours = T.encode(code, torch.from_numpy(info))
    ref = J.encode(code, jnp.asarray(info))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("rate", RATES)
def test_decode_matches_jax_on_golden(golden_dir, rate):
    code = ldpc.get_code(rate)
    llr = _golden_llr(golden_dir, rate)
    ours = T.decode(code, torch.from_numpy(llr))
    _assert_same(ours, J.decode(code, jnp.asarray(llr)))
    assert bool(ours[1].all())


@pytest.mark.parametrize("rate,sigma", [(CodeRate.R1_2, 0.62),
                                        (CodeRate.R1_4, 1.1)])
def test_decode_matches_jax_under_noise(rate, sigma):
    code = ldpc.get_code(rate)
    llr = _noisy_llr(rate, sigma)
    ours = T.decode(code, torch.from_numpy(llr))
    ok = ours[1].numpy()
    assert 0.0 < ok.mean() < 1.0          # both outcomes occur
    assert (ours[2].numpy() > 0).any()    # and multi-iteration lanes
    _assert_same(ours, J.decode(code, jnp.asarray(llr)))


@pytest.mark.parametrize("rate,sigma", [(CodeRate.R1_2, 0.62),
                                        (CodeRate.R1_4, 1.1)])
def test_decode_matches_pallas_interpret(rate, sigma):
    code = ldpc.get_code(rate)
    llr = _noisy_llr(rate, sigma)
    bits, ok, iters = T.decode(code, torch.from_numpy(llr))
    bits_p, ok_p, it_p = decode_pallas(code, jnp.asarray(llr), interpret=True)
    ok = ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ok_p))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(it_p))
    np.testing.assert_array_equal(bits.numpy()[ok], np.asarray(bits_p)[ok])


@pytest.mark.parametrize("max_iters", [0, 1])
def test_decode_matches_jax_at_few_iterations(max_iters):
    code = ldpc.get_code(CodeRate.R1_2)
    llr = _noisy_llr(CodeRate.R1_2, 0.62)
    ours = T.decode(code, torch.from_numpy(llr), max_iters=max_iters)
    _assert_same(ours, J.decode(code, jnp.asarray(llr), max_iters=max_iters))
    if max_iters == 0:
        assert not ours[1].any() and not ours[2].any()


def test_decode_trap_escape_matches_jax():
    code = ldpc.get_code(CodeRate.R1_2)
    llr = _noisy_llr(CodeRate.R1_2, 0.62)
    ours = T.decode(code, torch.from_numpy(llr), max_iters=6,
                    trap_escape=True)
    _assert_same(ours, J.decode(code, jnp.asarray(llr), max_iters=6,
                                trap_escape=True))
    plain = T.decode(code, torch.from_numpy(llr), max_iters=6)
    assert ours[1].sum() > plain[1].sum()  # the retry rescued some lanes


def test_cpu_decode_runs_the_plain_version():
    code = ldpc.get_code(CodeRate.R1_2)
    llr = torch.from_numpy(_noisy_llr(CodeRate.R1_2, 0.62, B=4))
    before = cuda_ldpc.launches
    bits, ok, iters = T.decode(code, llr)
    assert cuda_ldpc.launches == before
    llr_total, ok_p, iters_p = T.decode_plain(T.graph_for(code, llr.device),
                                              llr)
    assert torch.equal(bits, (llr_total[:, :code.k] < 0).to(torch.uint8))
    assert torch.equal(ok, ok_p) and torch.equal(iters, iters_p)


def test_kernel_wrapper_refuses_cpu_tensors():
    code = ldpc.get_code(CodeRate.R1_2)
    graph = T.graph_for(code, torch.device("cpu"))
    with pytest.raises(ValueError):
        cuda_ldpc.launch(graph, torch.zeros((2, code.n)), 50)
    with pytest.raises(ValueError):
        cuda_ldpc.decode_cuda(graph, torch.zeros((2, code.n)))


# ---------------------------------------------------------------------------
# The CUDA kernel's launch shape (the kernel itself runs only on the card:
# tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 3, 131, 256, 512, 513, 2048, 4096, 16384])
@pytest.mark.parametrize("sms", [132, 114])
def test_kernel_block_size_rule(B, sms):
    threads = cuda_ldpc.block_threads_for(B, sms)
    # Blocks of 256 threads only where each SM gets enough codewords to
    # fill it; a small batch gives each codeword 1,024.
    assert threads == (256 if B / sms >= cuda_ldpc.WIDE_BELOW else 1024)
    if sms == 132:
        assert threads == {16384: 256, 4096: 256, 2048: 256, 513: 1024,
                           512: 1024, 256: 1024, 131: 1024, 3: 1024,
                           1: 1024}[B]


@pytest.mark.parametrize("rate", RATES)
def test_kernel_tables_sort_rows_and_decode_alike(rate):
    """The kernel's tables: the check rows sorted by degree, descending,
    each variable's edges at their sorted rows, in the same (ascending
    original check) order, and each variable's degree.  The plain decoder on that sorted graph equals
    the JAX decoder lane for lane."""
    code = ldpc.get_code(rate)
    graph = T.graph_for(code, torch.device("cpu"))
    deg = graph.sorted_row_deg
    assert bool((deg[:-1] >= deg[1:]).all())
    order = np.argsort(-code.row_mask.sum(1), kind="stable")
    np.testing.assert_array_equal(graph.sorted_row_vars.numpy(),
                                  code.row_vars[order])
    m, D = code.m, code.max_degree
    old, new = graph.var_edges.numpy(), graph.sorted_var_edges.numpy()
    pad = old >= D * m
    np.testing.assert_array_equal(new >= D * m, pad)
    # Same check slot d, and the sorted row holds the original row.
    np.testing.assert_array_equal((new // m)[~pad], (old // m)[~pad])
    np.testing.assert_array_equal(order[(new % m)[~pad]], (old % m)[~pad])
    # Each variable's degree; its edges come first, the padding after.
    var_deg = graph.var_deg.numpy()
    np.testing.assert_array_equal(var_deg, (~pad).sum(1))
    np.testing.assert_array_equal(np.arange(graph.Dv)[None] < var_deg[:, None],
                                  ~pad)

    class Sorted:
        row_vars, var_edges, Dv = (graph.sorted_row_vars,
                                   graph.sorted_var_edges, graph.Dv)
        row_mask = torch.from_numpy(code.row_mask[order])

    sigma = {CodeRate.R1_4: 1.1, CodeRate.R1_2: 0.62}.get(rate, 0.5)
    llr = _noisy_llr(rate, sigma)
    ours = T.decode_plain(Sorted, torch.from_numpy(llr), max_iters=12)
    ref = J.decode(code, jnp.asarray(llr), max_iters=12)
    np.testing.assert_array_equal((ours[0][:, :code.k] < 0).numpy(),
                                  np.asarray(ref[0]).astype(bool))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
