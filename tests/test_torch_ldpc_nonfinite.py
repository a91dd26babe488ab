"""The plain LDPC decoder of the PyTorch port on LLRs with +-inf and NaN,
against the JAX decoder run op by op (``jax.disable_jit()``).

The batches are ``nonfinite_llrs`` of tests/test_torch_cuda.py (the
waterfall points R1/2 sigma 0.62 and R1/4 sigma 1.1, 1-3 LLRs of every
even lane set to +-inf or to NaN) at B = 32.  A NaN reaches the decoder
as an LLR (the demappers' ``clip_llr`` passes it on, as JAX's does) or is
made where +inf and -inf meet in a variable's total; ``jnp.clip`` and
``jnp.minimum`` keep it, and so must the port and both instantiations of
the CUDA kernel (held to the plain decoder on the card by
tests/test_torch_cuda.py::test_kernels_at_nonfinite_llrs).

* the plain decoder equals op-by-op JAX lane for lane (bits, ok flags,
  iterations) at both rates, with both kinds of poison, with float32 and
  bfloat16 messages, and once with trap_escape;
* a CPU model of the kernel's earlier semantics (``fminf``/``fmaxf``
  clamp, min2 by compare and select, which drop a NaN) disagrees with JAX
  on every one of those batches: the batches catch that fault;
* the port equals jitted JAX on the lanes jitted JAX decodes.  Jitted on
  the CPU, XLA contracts the decoder's ``llr_total - c2v`` into fused
  multiply-adds, so its totals differ from op-by-op JAX and the port by
  about an ulp, and on these batches its failed lanes' bits can differ
  (ROADMAP Queue 3, reference behaviours); that disagreement depends on
  XLA's version and is not asserted;
* the demappers hand a NaN on (``clip_llr``, ``demap_bpsk``'s 0/0,
  ``demap_dqpsk`` of a NaN symbol) exactly as JAX's do.

Op-by-op JAX costs per operation, not per lane: the file takes ~40 s in
one process (20 tests).
"""

import functools
import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16"):
    os.environ.pop(_flag, None)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.fec import ldpc  # noqa: E402
from projectultra_tpu.ops import demap as JDM  # noqa: E402
from projectultra_tpu.ops import ldpc as J  # noqa: E402

from projectultra_tpu_torch.fec.ldpc import V2C_CLAMP  # noqa: E402
from projectultra_tpu_torch.ops import demap as TDM  # noqa: E402
from projectultra_tpu_torch.ops import ldpc as T  # noqa: E402

from test_torch_cuda import NONFINITE, nonfinite_llrs  # noqa: E402

B = 32
MSG = {"f32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}
CASES = [(rate, sigma, kind, msg) for rate, sigma in NONFINITE
         for kind in ("inf", "nan") for msg in MSG]


def _ids(case):
    rate, _, kind, msg = case
    return f"{rate.name}-{kind}-{msg}"


@functools.lru_cache(maxsize=None)
def _batch(rate, sigma, kind):
    return nonfinite_llrs(rate, sigma, B, kind)


@functools.lru_cache(maxsize=None)
def _jax(rate, sigma, kind, msg, trap_escape=False, op_by_op=True):
    """JAX ``decode`` on the batch: (bits, ok, iters) as numpy arrays."""
    code = ldpc.get_code(rate)
    x = jnp.asarray(_batch(rate, sigma, kind))
    kw = {"msg_dtype": MSG[msg][1], "trap_escape": trap_escape}
    if op_by_op:
        with jax.disable_jit():
            out = J.decode(code, x, **kw)
    else:
        out = J.decode(code, x, **kw)
    return tuple(np.asarray(o) for o in out)


def _port(rate, sigma, kind, msg, trap_escape=False):
    graph = T.graph_for(ldpc.get_code(rate), torch.device("cpu"))
    x = torch.from_numpy(_batch(rate, sigma, kind))
    return T.decode_plain(graph, x, trap_escape=trap_escape,
                          msg_dtype=MSG[msg][0])


def _lanes_differ(k, ours, ref):
    """[B] bool: bits, ok flag or iterations differ."""
    bits = (ours[0][:, :k] < 0).numpy()
    return ((bits != ref[0].astype(bool)).any(1)
            | (ours[1].numpy() != ref[1]) | (ours[2].numpy() != ref[2]))


@pytest.fixture
def earlier_kernel(monkeypatch):
    """The plain decoder with the CUDA kernel's semantics before this
    repair patched in: v2c clamped with fmin/fmax (a NaN becomes -50) and
    min2 kept by compare and select (a NaN candidate is dropped)."""

    def next_v2c(graph, llr_total, c2v, msg_dtype=torch.float32):
        v = llr_total[:, graph.row_vars.T] - c2v
        v = torch.fmin(torch.fmax(v, torch.tensor(-V2C_CLAMP)),
                       torch.tensor(V2C_CLAMP))
        return T._stored(torch.where(graph.row_mask.T, v, 0.0), msg_dtype)

    def two_minima(graph, v2c):
        mask = graph.row_mask.T
        inf = torch.tensor(float("inf"))
        Bq, D, m = v2c.shape
        min1, min2 = inf.expand(Bq, m), inf.expand(Bq, m)
        amin = torch.zeros((Bq, m), dtype=torch.int32)
        par = torch.zeros((Bq, m), dtype=torch.int32)
        negs = []
        for d in range(D):
            a = torch.where(mask[d], v2c[:, d].abs(), inf)
            neg = (mask[d] & (v2c[:, d] < 0)).to(torch.int32)
            negs.append(neg)
            par = par ^ neg
            is_new = a < min1
            min2 = torch.where(is_new, min1, torch.where(a < min2, a, min2))
            amin = torch.where(is_new, d, amin)
            min1 = torch.where(is_new, a, min1)
        return min1, min2, amin, par, negs

    monkeypatch.setattr(T, "_next_v2c", next_v2c)
    monkeypatch.setattr(T, "_two_minima", two_minima)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_decoder_equals_jax_op_by_op(case):
    rate, sigma, kind, msg = case
    x = _batch(rate, sigma, kind)
    assert (~np.isfinite(x[::2])).any(1).all() and np.isfinite(x[1::2]).all()
    ref = _jax(rate, sigma, kind, msg)
    ours = _port(rate, sigma, kind, msg)
    k = ldpc.get_code(rate).k
    assert not _lanes_differ(k, ours, ref).any()
    assert torch.isnan(ours[0]).any(1).sum() > 0   # NaN totals reached
    assert 0 < int(ours[1].sum()) < B


def test_plain_decoder_with_trap_escape_equals_jax_op_by_op():
    rate, sigma = NONFINITE[1]
    ref = _jax(rate, sigma, "nan", "f32", trap_escape=True)
    ours = _port(rate, sigma, "nan", "f32", trap_escape=True)
    assert not _lanes_differ(ldpc.get_code(rate).k, ours, ref).any()
    # the retry rescued lanes the first pass left
    assert int(ours[1].sum()) > int(_port(rate, sigma, "nan", "f32")[1].sum())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_earlier_kernel_semantics_disagree_with_jax(earlier_kernel, case):
    """The fault of both kernel instantiations before the repair, modelled
    on the CPU: the same batches catch it."""
    rate, sigma, kind, msg = case
    ref = _jax(rate, sigma, kind, msg)
    model = _port(rate, sigma, kind, msg)
    assert _lanes_differ(ldpc.get_code(rate).k, model, ref).any()


@pytest.mark.parametrize("kind", ["inf", "nan"])
def test_port_equals_jitted_jax_on_its_ok_lanes(kind):
    """R1/4 float32, where jitted JAX's contracted sums can reach the
    failed lanes' bits: the port equals op-by-op JAX on every lane, and
    jitted JAX on the lanes it decodes (ok, bits, iterations).  Under -s
    it prints the lanes where jitted JAX differs from the port and how
    often a jitted a + s*m*0.75 differs from the same ops rounded one by
    one (the contraction; not asserted, it depends on XLA's version)."""
    rate, sigma = NONFINITE[1]
    k = ldpc.get_code(rate).k
    ours = _port(rate, sigma, kind, "f32")
    assert not _lanes_differ(k, ours, _jax(rate, sigma, kind, "f32")).any()
    bits, ok, iters = _jax(rate, sigma, kind, "f32", op_by_op=False)
    a, s, m = np.random.default_rng(0).standard_normal((3, 100_000)) \
        .astype(np.float32)
    fused = np.asarray(jax.jit(lambda a, s, m: a + s * m * 0.75)(a, s, m))
    c = s * m * np.float32(0.75)
    ulps = np.abs(fused - (a + c)) / np.spacing(np.maximum(abs(a), abs(c)))
    print(f"jitted JAX ({kind} LLRs, R1/4 f32): "
          f"{int(_lanes_differ(k, ours, (bits, ok, iters)).sum())} of {B} "
          f"lanes differ from the port; a + s*m*0.75 jitted: "
          f"{int((ulps > 0).sum())} of 100,000 elements differ from the "
          f"ops rounded one by one, by at most {float(ulps.max())} ulp of "
          f"the larger term")
    assert ok.any()
    assert ours[1].numpy()[ok].all()
    np.testing.assert_array_equal((ours[0][:, :k] < 0).numpy()[ok],
                                  bits[ok].astype(bool))
    np.testing.assert_array_equal(ours[2].numpy()[ok], iters[ok])


def test_demappers_hand_a_nan_on():
    """``clip_llr`` keeps a NaN (and clips +-inf to +-10) in both packages;
    ``demap_bpsk``'s -2 re / nv is NaN at 0 / 0, and ``demap_dqpsk`` of a
    lane with one NaN symbol gives NaN LLRs for it and the symbol after it
    (its reference), equal to JAX's elsewhere."""
    x = np.array([np.nan, np.inf, -np.inf, 0.2, -0.0, -3.0], np.float32)
    ours = TDM.clip_llr(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(JDM.clip_llr(
        jnp.asarray(x))))
    np.testing.assert_array_equal(ours[:3], [np.nan, 10.0, -10.0])

    zero = np.zeros(2, np.complex64)
    nv = np.float32(0.0)
    ours = TDM.demap_bpsk(torch.from_numpy(zero), torch.tensor(nv)).numpy()
    assert np.isnan(ours).all()
    np.testing.assert_array_equal(ours, np.asarray(
        JDM.demap_bpsk(jnp.asarray(zero), jnp.asarray(nv))))

    rng = np.random.default_rng(5)
    phase = rng.integers(0, 4, 17) * (np.pi / 2) + np.pi / 4
    sym = (np.exp(1j * phase) + 0.1 * (rng.standard_normal(17)
                                       + 1j * rng.standard_normal(17)))
    sym = sym.astype(np.complex64)
    sym[7] = np.complex64(complex(np.nan, np.nan))
    cur, prev = sym[None, 1:], sym[None, :-1]
    nv = np.float32(0.05)
    ours = TDM.demap_dqpsk(torch.from_numpy(cur), torch.from_numpy(prev),
                           torch.tensor(nv)).numpy()
    ref = np.asarray(JDM.demap_dqpsk(jnp.asarray(cur), jnp.asarray(prev),
                                     jnp.asarray(nv)))
    nan = np.isnan(ours).any(-1)[0]
    np.testing.assert_array_equal(np.flatnonzero(nan), [6, 7])
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours[0, ~nan], ref[0, ~nan], rtol=1e-5,
                               atol=1e-5)
