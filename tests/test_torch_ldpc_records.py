"""The bf16 LDPC kernel's check-row records, modelled in plain PyTorch
(``ops/ldpc.pack_records``, ``rebuild_c2v``, ``records_c2v``), and its
(row << 3 | slot) variable table (``LDPCGraph.sorted_var_slots``).

The bf16 kernel keeps, per check row, min1 and min2 as bf16 bits, the slot
of min1 and the c2v sign bits instead of D float32 c2v values, and rebuilds
each c2v where a pass reads it.  These tests hold that record to the plain
decoder's c2v bit for bit:

* every bf16 bit pattern, as min1 and as min2, with both signs (a NaN is
  never min1; a NaN min2 is stored as 0x7fff and rebuilds to a NaN c2v
  where ``_c2v`` gives one: NaN equals NaN, every other value bit for
  bit), and rows where a NaN is min2 and where a later minimum drops it;
* the bf16 v2c messages of every iteration of a decode at each of the five
  rates' waterfall batches (numpy-seeded), a decode whose bits, ok flags
  and iterations equal JAX ``decode(msg_dtype=jnp.bfloat16)``;

and the table to the kernel's contract: each variable's edges at their
sorted rows and slots, in ascending original-check order, -1 beyond its
degree; the plain decoder whose c2v go through records and whose sums run
through the table equals JAX's bf16 decode lane for lane at the five
rates.  The kernel itself runs on the card (tests/test_torch_cuda.py).
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16"):
    os.environ.pop(_flag, None)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.config import CodeRate  # noqa: E402
from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ops import ldpc as J  # noqa: E402

from projectultra_tpu_torch.ops import ldpc as T  # noqa: E402

RATES = [CodeRate.R1_4, CodeRate.R1_2, CodeRate.R2_3, CodeRate.R3_4,
         CodeRate.R5_6]
SIGMA = {CodeRate.R1_4: 1.1, CodeRate.R1_2: 0.62}   # else 0.5
BF16 = torch.bfloat16


def _noisy_llr(rate, B=24):
    """The waterfall batch of tests/test_torch_ldpc.py at the rate's
    sigma."""
    sigma = SIGMA.get(rate, 0.5)
    code = ldpc.get_code(rate)
    rng = np.random.default_rng(1234)
    info = rng.integers(0, 2, size=(B, code.k)).astype(np.uint8)
    cw = np.stack([ldpc.encode_block_np(code, info[b]) for b in range(B)])
    y = (1.0 - 2.0 * cw.astype(np.float32)) \
        + sigma * rng.standard_normal(cw.shape).astype(np.float32)
    return (2.0 * y / (sigma * sigma)).astype(np.float32)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_bit_equal_or_both_nan(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


def _round_trip(graph, v2c):
    return T.records_c2v(graph, T.pack_records(graph, v2c))


def _assert_same_as_jax(ours, llr, rate, **kw):
    code = ldpc.get_code(rate)
    ref = J.decode(code, jnp.asarray(llr), msg_dtype=jnp.bfloat16, **kw)
    np.testing.assert_array_equal((ours[0][:, :code.k] < 0).numpy(),
                                  np.asarray(ref[0]).astype(bool))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))


class _Rows:
    """A graph of m rows of degree D, every slot an edge."""

    def __init__(self, m, D):
        self.row_mask = torch.ones((m, D), dtype=torch.bool)


def test_every_bf16_pattern_rebuilds_bit_equal():
    """Each bf16 value x in rows (x, y): y = +-inf leaves |x| as min1
    (a NaN x: min2, NaN), y = +-0 makes it min2 (a NaN x: dropped), and the
    signs of y flip the c2v's; plus random rows of seven such values.  A
    NaN c2v rebuilds to NaN (its payload is the record's), every other
    one bit for bit."""
    pats = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    x = pats.view(BF16).to(torch.float32)
    assert x.numel() == 2 ** 16 and int(torch.isnan(x).sum()) == 254
    ys = torch.tensor([float("inf"), -float("inf"), 0.0, -0.0, 1.0, -1.0])
    rows = torch.stack([x.repeat(len(ys)), ys.repeat_interleave(x.numel())])
    graph = _Rows(rows.shape[1], 2)
    v2c = rows[None]
    want = T._c2v(graph, v2c)
    assert bool(torch.isnan(want).any())
    _assert_bit_equal_or_both_nan(_round_trip(graph, v2c), want)

    rng = np.random.default_rng(7)
    v2c7 = x[torch.from_numpy(rng.integers(0, x.numel(), (3, 7, 4096)))]
    graph7 = _Rows(4096, 7)
    _assert_bit_equal_or_both_nan(_round_trip(graph7, v2c7),
                                  T._c2v(graph7, v2c7))


def test_nan_min2_and_dropped_nan_rebuild_as_c2v():
    """Rows of three slots: a NaN after min1 becomes min2 and stays it
    (the argmin slot's c2v is NaN, min2's bits 0x7fff); a NaN before two
    new minima is dropped (no NaN c2v); a NaN after a later minimum is
    min2 again; NaN on every slot leaves min1 inf, its slot 0 (no new
    minimum) and min2 NaN."""
    nan, inf = float("nan"), float("inf")
    rows = torch.tensor([[1.0, nan, 2.0],      # min1 1, min2 NaN
                         [nan, 1.0, 0.5],      # the NaN dropped
                         [-0.5, 4.0, nan],     # min1 0.5, min2 NaN
                         [nan, nan, nan]])     # min1 inf, min2 NaN
    graph = _Rows(4, 3)
    v2c = rows.T[None]                         # [1, D, m]
    want = T._c2v(graph, v2c)[0].T             # [m, D]
    nan_at = torch.tensor([[True, False, False], [False] * 3,
                           [True, False, False], [True, False, False]])
    assert torch.equal(torch.isnan(want), nan_at)
    records = T.pack_records(graph, v2c)[0]
    assert [int(r) & 0xFFFF for r in records[:, 0]] == [0x7FFF, 0x3F80,
                                                        0x7FFF, 0x7FFF]
    _assert_bit_equal_or_both_nan(_round_trip(graph, v2c)[0].T, want)


@pytest.mark.parametrize("rate", RATES)
def test_records_rebuild_the_c2v_of_a_bf16_decode(monkeypatch, rate):
    """Every v2c the plain bf16 decoder hands to ``_c2v`` (iteration 0's
    rounded channel LLRs and each later iteration's messages) packs and
    rebuilds to ``_c2v``'s c2v bit for bit; the decode equals JAX's."""
    code = ldpc.get_code(rate)
    graph = T.graph_for(code, torch.device("cpu"))
    llr = _noisy_llr(rate)
    seen = []
    c2v = T._c2v

    def recording(g, v2c):
        seen.append(v2c)
        return c2v(g, v2c)

    monkeypatch.setattr(T, "_c2v", recording)
    ours = T.decode_plain(graph, torch.from_numpy(llr), msg_dtype=BF16)
    monkeypatch.undo()
    _assert_same_as_jax(ours, llr, rate)
    assert len(seen) > 2 and bool((ours[2] > 0).any())
    for v2c in seen:
        assert torch.equal(v2c, v2c.to(BF16).to(torch.float32))
        assert torch.equal(_bits(_round_trip(graph, v2c)),
                           _bits(c2v(graph, v2c)))


@pytest.mark.parametrize("rate", RATES)
def test_slot_table_keeps_check_order_and_decodes_alike(monkeypatch, rate):
    """``sorted_var_slots`` names each variable's edges as (sorted row << 3
    | slot), in ascending ORIGINAL check order, -1 beyond its degree; the
    plain decoder on it, its c2v through the records, equals JAX's bf16
    decode lane for lane."""
    code = ldpc.get_code(rate)
    graph = T.graph_for(code, torch.device("cpu"))
    m, D = code.m, code.max_degree
    slots = graph.sorted_var_slots.numpy()
    var_deg = graph.var_deg.numpy()
    real = np.arange(graph.Dv)[None] < var_deg[:, None]
    np.testing.assert_array_equal(slots < 0, ~real)
    row, slot = np.where(real, slots >> 3, 0), np.where(real, slots & 7, 0)
    order = np.argsort(-code.row_mask.sum(1), kind="stable")
    v = np.broadcast_to(np.arange(code.n)[:, None], slots.shape)
    np.testing.assert_array_equal(
        graph.sorted_row_vars.numpy()[row, slot][real], v[real])
    assert (slot[real] < graph.sorted_row_deg.numpy()[row[real]]).all()
    original = np.where(real, order[row], m)
    assert (np.diff(original, axis=1)[real[:, 1:]] > 0).all()
    np.testing.assert_array_equal(
        np.where(real, slot * m + row, D * m), graph.sorted_var_edges.numpy())

    class OnSlots:
        row_vars = graph.sorted_row_vars
        row_mask = torch.from_numpy(code.row_mask[order])
        var_edges = torch.from_numpy(np.where(real, slot * m + row, D * m))
        Dv = graph.Dv

    monkeypatch.setattr(T, "_c2v", _round_trip)
    llr = _noisy_llr(rate)
    ours = T.decode_plain(OnSlots, torch.from_numpy(llr), max_iters=12,
                          msg_dtype=BF16)
    monkeypatch.undo()
    _assert_same_as_jax(ours, llr, rate, max_iters=12)
