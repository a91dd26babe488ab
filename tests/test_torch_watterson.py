"""The Watterson HF channel of the PyTorch port against the JAX package.

JAX's PRNG cannot be reproduced in torch, so the tests redraw JAX's
normals from the same key splits as ``watterson`` (key -> fade, noise,
cfo; fade -> real, imaginary) and pass them to ``watterson_with``.
Tolerances:

* presets: ``dataclasses.asdict`` equal;
* ``_ar1_scan``: rtol 1e-4 against the JAX associative scan (elementwise,
  plus an absolute floor of 1e-4 of the sequence's RMS for the deep
  fades where the taps pass near 0), at the 0.1 Hz (``good``) and 10 Hz
  (``flutter``) Doppler;
* ``watterson_with``: max abs difference <= 1e-4 of the output's peak.

JAX reads ULTRA_CHIRP_BF16 and ULTRA_LDPC_BF16 at import; both are removed
before the JAX package is imported (neither reaches this module).
"""

import os

for _flag in ("ULTRA_CHIRP_BF16", "ULTRA_LDPC_BF16"):
    os.environ.pop(_flag, None)

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from projectultra_tpu.sim import watterson as JW  # noqa: E402
from projectultra_tpu.sync import chirp as JC  # noqa: E402

from projectultra_tpu_torch.sim import watterson as TW  # noqa: E402


@pytest.fixture(autouse=True)
def _float32_reference():
    assert "ULTRA_CHIRP_BF16" not in os.environ
    assert "ULTRA_LDPC_BF16" not in os.environ
    assert JC._BF16 is False


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("table", ["PRESETS", "HARNESS_PRESETS"])
def test_presets_match_jax(table):
    ours, ref = getattr(TW, table), getattr(JW, table)
    assert ours.keys() == ref.keys()
    for name in ref:
        for snr in (-3.0, 5.0, 25.0):
            assert dataclasses.asdict(ours[name](snr)) == \
                dataclasses.asdict(ref[name](snr)), (name, snr)
        if name != "awgn" and table == "PRESETS":
            assert dataclasses.asdict(ours[name]()) == \
                dataclasses.asdict(ref[name]())
    assert dataclasses.asdict(TW.ChannelConfig()) == \
        dataclasses.asdict(JW.ChannelConfig())


def _alpha(doppler):
    return 1.0 - np.exp(-2.0 * np.pi * doppler / 48000.0)


@pytest.mark.parametrize("doppler,T", [(0.1, 30001), (10.0, 131),
                                       (10.0, 84000)])
def test_ar1_scan_matches_jax(doppler, T):
    """At flutter's 10 Hz over 84,000 samples a closed form with a global
    (1-a)^-n scale would reach e^110 and overflow float32."""
    a = _alpha(doppler)
    rng = np.random.default_rng(T)
    x = (rng.standard_normal((2, 2, T)) + 1j * rng.standard_normal((2, 2, T))
         ).astype(np.complex64) * np.float32(np.sqrt(1.0 / a))
    y0 = np.complex64(1.0 + 0j)
    ref = np.asarray(jax.jit(JW._ar1_scan, static_argnums=0)(
        a, jnp.asarray(x), y0))
    ours = TW._ar1_scan(a, _t(x), 1.0 + 0j).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.complex64
    assert np.isfinite(ours).all()
    rms = np.sqrt((np.abs(ref) ** 2).mean())
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * rms)


def test_ar1_scan_initial_state():
    """A tensor y0 per row; with zero input the output is y0 (1-a)^(n+1)."""
    a = _alpha(10.0)
    y0 = torch.tensor([1.0 + 0j, -0.5 + 2j], dtype=torch.complex64)
    y = TW._ar1_scan(a, torch.zeros((2, 1000), dtype=torch.complex64), y0)
    decay = (1.0 - a) ** np.arange(1, 1001)
    np.testing.assert_allclose(y.numpy(), y0.numpy()[:, None] * decay,
                               rtol=1e-5, atol=1e-7)


def _jax_normals(key, cfg, B, T):
    """The normals ``JW.watterson`` draws from ``key``."""
    k_fade, k_noise, _ = jax.random.split(key, 3)
    delay = int(cfg.delay_spread_ms * cfg.sample_rate / 1000.0)
    paths = 2 if cfg.multipath_enabled and delay > 0 else 1
    kr, ki = jax.random.split(k_fade)
    fade = np.stack([np.asarray(jax.random.normal(kr, (B, paths, T))),
                     np.asarray(jax.random.normal(ki, (B, paths, T)))])
    awgn = np.asarray(jax.random.normal(k_noise, (B, T)))
    return fade, awgn


def _signal(B, T, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, T), np.float32)
    x[:, 500:T - 500] = rng.standard_normal((B, T - 1000)).astype(np.float32)
    return x


@pytest.mark.parametrize("name,table", [("awgn", "PRESETS"),
                                        ("moderate", "PRESETS"),
                                        ("poor", "PRESETS"),
                                        ("good", "HARNESS_PRESETS")])
def test_watterson_with_matches_jax(name, table):
    cfg_j = getattr(JW, table)[name](12.0)
    cfg_t = getattr(TW, table)[name](12.0)
    B, T = 3, 12000
    x = _signal(B, T)
    key = jax.random.PRNGKey(17)
    ref = np.asarray(JW.watterson(key, jnp.asarray(x), cfg_j))
    fade, awgn = _jax_normals(key, cfg_j, B, T)
    ours = TW.watterson_with(_t(x), cfg_t,
                             _t(fade) if cfg_t.fading_enabled else None,
                             _t(awgn)).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_watterson_with_cfo_and_fixed_paths_matches_jax():
    """The CFO branch and unfaded multipath (the delay + 1 shift)."""
    cfg_j = JW.ChannelConfig(snr_db=20.0, cfo_hz=17.0, fading_enabled=False)
    cfg_t = TW.ChannelConfig(snr_db=20.0, cfo_hz=17.0, fading_enabled=False)
    B, T = 2, 9000
    x = _signal(B, T, seed=3)
    key = jax.random.PRNGKey(2)
    ref = np.asarray(JW.watterson(key, jnp.asarray(x), cfg_j))
    _, awgn = _jax_normals(key, cfg_j, B, T)
    ours = TW.watterson_with(_t(x), cfg_t, None, _t(awgn)).numpy()
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
    quiet = dataclasses.replace(cfg_t, noise_enabled=False, cfo_enabled=False)
    imp = torch.zeros((1, 400))
    imp[0, 10] = 1.0
    out = TW.watterson_with(imp, quiet)[0]
    delay = int(cfg_t.delay_spread_ms * 48)
    assert out[10] == np.float32(0.707) and out[11 + delay] == np.float32(0.707)
    assert int((out != 0).sum()) == 2


def test_watterson_draws_from_the_generator():
    """The wrapper on the generator's normals equals ``watterson_with`` on
    the same draws, and its taps have unit mean power."""
    cfg = TW.HARNESS_PRESETS["moderate"](10.0)
    x = torch.from_numpy(_signal(2, 6000))
    out = TW.watterson(x, cfg, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    fade = torch.randn((2, 2, 2, 6000), generator=g)
    awgn = torch.randn((2, 6000), generator=g)
    assert torch.equal(out, TW.watterson_with(x, cfg, fade, awgn))
    taps = TW.rayleigh_taps(TW.flutter(), (64, 1), 20000,
                            torch.Generator().manual_seed(1))
    assert taps.shape == (64, 1, 20000) and taps.dtype == torch.complex64
    power = float((taps.abs() ** 2).mean())
    assert 0.85 < power < 1.15, power
