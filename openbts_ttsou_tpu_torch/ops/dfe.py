"""Decision-feedback equalizer: design + burst equalization.

Port of `openbts_ttsou_tpu/ops/dfe.py`. Reference behavior:
`Transceiver/sigProcLib.cpp:1246-1340` (designDFE, the Al-Dhahir &
Cioffi Cholesky-factor recursion) and `:1343-1399` (equalizeBurst).
The batch is an explicit leading dimension. The per-symbol feedback
recursion is one launch of K5 (`csrc/dfe_equalize.cu`) on the card and
a Python loop over the burst's samples on the CPU.
"""

from __future__ import annotations

import torch

from openbts_ttsou_tpu_torch.ops import cuda_dfe, fir, gmsk
from openbts_ttsou_tpu_torch.utils.tables import copy_table


def _design_dfe_batched(chan: torch.Tensor, snr: torch.Tensor, nf: int):
    """designDFE for a batch: chan [N, L] complex, snr [N] → feedforward
    [N, nf], feedback [N, L-1] complex64."""
    chan = chan.to(torch.complex64)
    n, L = chan.shape
    nu = L - 1
    assert nu + 1 <= nf, "channel longer than feedforward span"
    dev = chan.device
    g0 = torch.zeros((n, nf), dtype=torch.complex64, device=dev)
    g0[:, 0] = (1.0 / torch.sqrt(snr.to(torch.float32))).to(torch.complex64)
    g1 = torch.zeros((n, nf), dtype=torch.complex64, device=dev)
    g1[:, : nu + 1] = torch.conj_physical(chan)

    rows = []
    d = None
    for i in range(nf):
        d = g0[:, 0].abs() ** 2 + g1[:, 0].abs() ** 2  # [N] f32
        li = torch.zeros((n, nf + nu), dtype=torch.complex64, device=dev)
        span = min(nf, nf + nu - i)  # iterator-bound guard (cpp:1276)
        li[:, i: i + span] = ((g0 * torch.conj_physical(g0[:, :1])
                               + g1 * torch.conj_physical(g1[:, :1]))
                              / d[:, None])[:, :span]
        rows.append(li)
        k = g1[:, 0] / g0[:, 0]
        if i != nf - 1:
            norm = (1.0 / torch.sqrt(1.0 + k.abs() ** 2))[:, None]
            g0n = (g1 * torch.conj_physical(k)[:, None] + g0) * norm
            g1n = (g1 - k[:, None] * g0) * norm
            # delayVector(G1new, -1.0): advance one symbol, zero-fill tail
            g1n = torch.cat([g1n[:, 1:], torch.zeros_like(g1n[:, :1])], 1)
            g0, g1 = g0n, g1n

    ll = torch.stack(rows, 1)  # [N, nf, nf+nu]
    feedback = -torch.conj_physical(ll[:, nf - 1, nf: nf + nu])

    v = torch.zeros((n, nf), dtype=torch.complex64, device=dev)
    v[:, nf - 1] = 1.0
    for kk in range(nf - 2, -1, -1):
        v[:, kk] = -(v[:, kk + 1: nf] * ll[:, kk, kk + 1: nf]).sum(-1)

    w = []
    for i in range(nf):
        end = min(nu, nf - 1 - i)
        wi = (v[:, i: i + end + 1]
              * torch.conj_physical(chan[:, : end + 1])).sum(-1)
        w.append(wi / d)
    feedforward = torch.stack(w, -1)
    return feedforward.to(torch.complex64), feedback.to(torch.complex64)


def design_dfe(chan: torch.Tensor, snr: torch.Tensor, nf: int = 7):
    """Batched DFE design. chan: [..., L]; snr: [...] (or broadcastable).
    Returns (feedforward [..., nf], feedback [..., L-1])."""
    lead = chan.shape[:-1]
    c2 = chan.reshape(-1, chan.shape[-1])
    s2 = torch.broadcast_to(torch.as_tensor(snr, device=chan.device),
                            lead).reshape(-1)
    w, b = _design_dfe_batched(c2, s2, nf)
    return w.reshape(lead + (nf,)), b.reshape(lead + b.shape[-1:])


def _feedforward(burst: torch.Tensor, toa: torch.Tensor,
                 feedforward: torch.Tensor) -> torch.Tensor:
    """Un-delay each burst by its TOA, then its feedforward filter:
    [B, T] complex64."""
    assert burst.ndim == 2, "equalize_burst expects [batch, time]"
    t = burst.shape[-1]
    nf = feedforward.shape[-1]
    x = gmsk.delay_vector(burst, -toa.to(torch.float32))
    return fir.convolve(x, feedforward, fir.CUSTOM, start=nf - 1, length=t)


def feedback_recursion_plain(pf: torch.Tensor, feedback: torch.Tensor,
                             rot: torch.Tensor) -> torch.Tensor:
    """The per-symbol recursion over the ring of the last nu rotated hard
    decisions, then the slicer: pf [B, T] complex64 (the feedforward
    output), feedback [B, nu] complex64, rot [T] complex64 → soft bits
    [B, T] in [0, 1]. K5's plain form, one eager step at a time."""
    bsz, t = pf.shape
    nu = feedback.shape[-1]
    rev = torch.conj_physical(rot)
    hist = torch.zeros((bsz, nu), dtype=torch.complex64, device=pf.device)
    one = torch.ones((), dtype=torch.complex64, device=pf.device)
    soft_pre = []
    for i in range(t):
        d = pf[:, i] + (feedback * hist).sum(-1)
        s = d * rev[i]
        dec = torch.where(s.real > 0.0, one, -one)
        hist = torch.cat([(dec * rot[i])[:, None], hist[:, :-1]], 1)
        soft_pre.append(s)
    return gmsk.vector_slicer(torch.stack(soft_pre, -1))  # [B, T]


def equalize_burst_plain(burst: torch.Tensor, toa: torch.Tensor, sps: int,
                         feedforward: torch.Tensor,
                         feedback: torch.Tensor) -> torch.Tensor:
    """`equalize_burst` with its recursion in the plain form on every
    device."""
    pf = _feedforward(burst, toa, feedforward)
    rot = copy_table(gmsk.rotation(burst.shape[-1], sps), burst.device)
    return feedback_recursion_plain(pf, feedback.to(torch.complex64), rot)


def equalize_burst(burst: torch.Tensor, toa: torch.Tensor, sps: int,
                   feedforward: torch.Tensor,
                   feedback: torch.Tensor) -> torch.Tensor:
    """DFE equalization to soft bits in [0,1] (equalizeBurst,
    sigProcLib.cpp:1343-1399).

    burst: [B, T] complex (symbol-rate); toa: [B]; feedforward [B, Nf];
    feedback [B, nu]. Un-delay by TOA and feedforward filter (eager ops),
    then the per-symbol recursion over the ring of the last nu rotated
    hard decisions: on a CUDA tensor one launch of K5
    (`cuda_dfe.equalize_cuda`), on the CPU `feedback_recursion_plain`."""
    pf = _feedforward(burst, toa, feedforward)
    rot = copy_table(gmsk.rotation(burst.shape[-1], sps), burst.device)
    b = feedback.to(torch.complex64)
    if pf.is_cuda:
        return cuda_dfe.equalize_cuda(pf.contiguous(), b.contiguous(), rot)
    return feedback_recursion_plain(pf, b, rot)
