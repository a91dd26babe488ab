"""Live-observability data export: waterfall + constellation.

Reference: src/gui/widgets/{waterfall,constellation}.  The rebuild omits the
ImGui GUI (SURVEY.md §7 stage 9) and instead exports the same data products
so any frontend (notebook, web UI) can render them: the waterfall is the
batched STFT the GUI computed per frame, the constellation comes from the
demodulators' equalized symbols.

The port of the JAX package's module: the waterfall runs on the device of
a tensor it is given (a host array on the CPU) and returns numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def waterfall(samples, fft_size: int = 2048, hop: int | None = None,
              max_lines: int = 200, sample_rate: float = 48000.0):
    """[T] or [B, T] audio -> (power_db [lines, fft/2+1], freqs [fft/2+1]).

    Matches the GUI waterfall's 2048-point FFT / 200-line window
    (src/gui/widgets/waterfall.cpp per docs/GUI_ARCHITECTURE.md).
    [B, T] input is flattened in time order (the GUI feeds one continuous
    stream; concatenation preserves every frame instead of silently
    dropping rows 1..B-1); inputs shorter than fft_size are zero-padded to
    one full line."""
    x = torch.as_tensor(samples, dtype=torch.float32).reshape(-1)
    if x.shape[-1] < fft_size:
        x = torch.nn.functional.pad(x, (0, fft_size - x.shape[-1]))
    hop = hop or fft_size // 2
    n_lines = min(max_lines, max(1, (x.shape[-1] - fft_size) // hop + 1))
    frames = x.unfold(0, fft_size, hop)[:n_lines] * torch.hann_window(
        fft_size, periodic=False, dtype=torch.float32, device=x.device)
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2
    power_db = 10.0 * torch.log10(spec + 1e-12)
    freqs = np.fft.rfftfreq(fft_size, 1.0 / sample_rate)
    return power_db.cpu().numpy(), freqs


def constellation(equalized, max_symbols: int = 500):
    """Flatten equalized symbols to at most max_symbols IQ points
    (MAX_CONSTELLATION_SYMBOLS, demodulator_constants.hpp:122)."""
    if isinstance(equalized, torch.Tensor):
        equalized = equalized.detach().cpu().numpy()
    pts = np.asarray(equalized).reshape(-1)
    if len(pts) > max_symbols:
        pts = pts[-max_symbols:]
    return np.stack([pts.real, pts.imag], axis=-1)
