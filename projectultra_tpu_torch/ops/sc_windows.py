"""Schmidl-Cox window sums at a stride (the port of
``ops/pallas_sync.py::sc_windows_pallas`` and of the block-grid sums of
``sync/schmidl_cox.py::detect_preamble``).

For lane b and g < G, with d = offset + stride * g:

* P[b, g]  = sum_{i<half} conj(a[b, d+i]) * a[b, d+i+half]
* R1[b, g] = sum_{i<half} |a[b, d+i]|^2
* R2[b, g] = sum_{i<half} |a[b, d+half+i]|^2

``sc_windows`` runs the hand-written CUDA kernel (``ops/cuda_sc.py``,
``csrc/sc_windows.cu``) for CUDA tensors and the plain PyTorch version
``sc_windows_plain`` for CPU tensors.  The plain version is also the
oracle the kernel is held to on the card.  Both are block-stable: no sum
runs longer than the window, and no global float32 cumsum is differenced.
"""

from __future__ import annotations

import torch


def window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """[..., T] -> [..., T-w+1] sliding sums of w elements, numerically
    stable (schmidl_cox.py::_window_sum): with block size w, the window
    starting at p = b*w + j is suffix(block b, j) + prefix(block b+1, j),
    so every term is an accumulation of at most w elements.

    The suffixes are scanned from the block's end, not taken as the block
    total less a prefix: a window over zeros (the zero-padded tail of a
    streaming view) then sums to exactly 0 whatever order the device's
    scan adds in, where total - prefix leaves a rounding residual (up to
    ~1e-4 on signal energies) that normalised correlations divide by."""
    T = x.shape[-1]
    nb = -(-T // w)
    pad = nb * w - T
    lead = x.shape[:-1]
    xp = torch.cat([x, torch.zeros((*lead, pad + w), dtype=x.dtype,
                                   device=x.device)], dim=-1)
    xb = xp.reshape(*lead, nb + 1, w)
    pre = torch.cumsum(xb, dim=-1)                      # prefix sums in block
    suf = torch.cumsum(xb.flip(-1), dim=-1).flip(-1)    # suffix sums in block
    nxt = torch.cat([torch.zeros_like(pre[..., :1, :]), pre[..., 1:, :]],
                    dim=-2)
    prev_pre = torch.cat([torch.zeros_like(nxt[..., :1]), nxt[..., :-1]],
                         dim=-1)
    head, tail = suf[..., :-1, :], prev_pre[..., 1:, :]
    if x.is_complex():
        # PyTorch adds complex tensors as head + (1+0j) * tail, and
        # inf * 0 makes an infinite part of tail NaN: add the real and
        # imaginary parts as floats, so each is the IEEE sum of its window.
        out = torch.view_as_complex(torch.view_as_real(head)
                                    + torch.view_as_real(tail))
    else:
        out = head + tail
    return out.reshape(*lead, -1)[..., :T - w + 1]


def check_args(T: int, half: int, stride: int, offset: int, G: int) -> None:
    """Raise ValueError unless every window of the G outputs lies in
    [0, T) on the stride grid."""
    if half < 1 or stride < 1 or half % stride:
        raise ValueError(f"half={half} must be a positive multiple of "
                         f"stride={stride}")
    if offset < 0 or offset % stride:
        raise ValueError(f"offset={offset} must be a non-negative multiple "
                         f"of stride={stride}")
    if G < 0 or (G and offset + stride * (G - 1) + 2 * half > T):
        raise ValueError(f"G={G} windows of 2*{half} samples from offset "
                         f"{offset} at stride {stride} overrun T={T}")


def sc_windows_plain(a: torch.Tensor, half: int, stride: int, offset: int,
                     G: int):
    """Plain PyTorch window sums of a [..., T] complex analytic signal ->
    (P [..., G] complex, R1 [..., G], R2 [..., G]).

    Stride 1 is ``sc_metric``'s form (schmidl_cox.py:102-106): window sums
    over the whole buffer, sliced at ``offset``.  A larger stride is
    ``detect_preamble``'s block-grid form (schmidl_cox.py:200-219):
    stride-sample block pre-reductions over a[..., :(T // stride) * stride],
    block-grid window sums, and R2 read from the energy sums half/stride
    blocks later."""
    T = a.shape[-1]
    check_args(T, half, stride, offset, G)
    if stride == 1:
        u = a[..., :-half].conj() * a[..., half:]
        e = a.abs() ** 2
        sl = (Ellipsis, slice(offset, offset + G))
        return (window_sum(u, half)[sl], window_sum(e[..., :-half], half)[sl],
                window_sum(e[..., half:], half)[sl])
    st, hb = stride, half // stride
    nb = T // st
    ab = a[..., :nb * st].reshape(*a.shape[:-1], nb, st)
    eb = (ab.real * ab.real + ab.imag * ab.imag).sum(-1)          # [..., nb]
    ub = (ab[..., :nb - hb, :].conj() * ab[..., hb:, :]).sum(-1)  # [..., nb-hb]
    Pb = window_sum(ub, hb)                                       # P at st*k
    Eb = window_sum(eb, hb)                                       # R1 at st*k
    k0 = offset // st
    return (Pb[..., k0:k0 + G], Eb[..., k0:k0 + G],
            Eb[..., k0 + hb:k0 + hb + G])


def sc_windows(a: torch.Tensor, half: int, stride: int, offset: int, G: int):
    """Device dispatch: the CUDA kernel for CUDA tensors ([B, T]
    complex64), the plain version for CPU tensors.  Returns (P, R1, R2)."""
    if a.device.type == "cuda":
        from . import cuda_sc  # imports this module
        return cuda_sc.sc_windows_cuda(a, half, stride, offset, G)
    if a.device.type != "cpu":
        raise ValueError(f"sc_windows runs on cuda or cpu, not {a.device}")
    return sc_windows_plain(a, half, stride, offset, G)
