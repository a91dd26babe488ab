"""The benchmark's reference against the port, on the CPU at a tiny batch:
the same info bits and normals give the same audio and the same decoded
bits, ok flags, iteration counts and detections."""

import pytest
import torch

from benchmark import traffic as traffic_mod
from benchmark.reference import channel as ref_channel
from benchmark.reference import mc_dpsk as ref_mc

from bench_cases import ACQUIRED, CPU, PRESYNCED, tiny_cell


@pytest.mark.parametrize("name", PRESYNCED)
def test_presynced_reference_equals_the_port(name):
    cell = tiny_cell(name)
    entry = cell.entry.Entry(cell.config, cell.traffic, CPU)
    info, noise = traffic_mod.inputs(cell.traffic, entry.k, entry.T, 7, 0,
                                     CPU)
    with entry.precision():
        out = entry.step(info, noise, lambda _n: None)
    ref = entry.reference()
    tx = ref.tx(info)
    rx = ref_channel.add_noise_with(tx, cell.traffic.snr_db, noise)
    bits, ok, iters = ref.rx(rx)
    assert torch.equal(out["tx"], tx) and torch.equal(out["rx"], rx)
    assert torch.equal(out["bits"], bits)
    assert torch.equal(out["ok"], ok) and torch.equal(out["iters"], iters)
    assert tx.shape == (cell.traffic.batch, cell.config["frame_samples"])


@pytest.mark.parametrize("name", ACQUIRED)
def test_acquired_reference_equals_the_port(name):
    cell = tiny_cell(name)
    entry = cell.entry.Entry(cell.config, cell.traffic, CPU)
    info, noise = traffic_mod.inputs(cell.traffic, entry.k, entry.T, 7, 0,
                                     CPU)
    with entry.precision():
        out = entry.step(info, noise, lambda _n: None)
    tx = ref_mc.tx_chirp_frame(entry.ref_mc, entry.ref_rate, info)
    rx = ref_channel.add_noise_with(tx, cell.traffic.snr_db, noise)
    bits, ok, iters, det = ref_mc.decode_chirp_batch(entry.ref_mc,
                                                     entry.ref_rate, rx)
    assert torch.equal(out["tx"], tx) and torch.equal(out["rx"], rx)
    assert torch.equal(out["bits"], bits) and torch.equal(out["ok"], ok)
    assert torch.equal(out["iters"], iters)
    for key in det:
        assert torch.equal(out["det"][key], det[key]), key
    assert bool(ok.all())


def test_reference_imports_nothing_of_the_program():
    import benchmark.reference as R
    from pathlib import Path
    for path in Path(R.__file__).parent.glob("*.py"):
        text = path.read_text()
        for name in ("projectultra_tpu", "jax"):
            assert f"import {name}" not in text, path
            assert f"from {name}" not in text, path
