"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from openbts_ttsou_tpu_torch.ops import cuda_fir
from openbts_ttsou_tpu_torch.ops import fir

# (p, q, taps, T, leading shape): the two shapes the system runs (the
# templated instantiations), the small ratios of the runtime-width and
# tail-group paths, one row, more tiles than the persistent grid holds
# (600 rows of one tile), odd T, k_max 25 (the runtime instantiation
# at the uplink ratio), and the largest q at p = 3 (one cycle a tile)
GEOMETRIES = [(65, 96, 961, 24000, (3, 2)), (96, 65, 651, 16250, (3, 2)),
              (3, 200, 31, 1000, (3, 2)), (7, 2, 50, 300, (3, 2)),
              (65, 96, 961, 24000, (1,)), (65, 96, 961, 2000, (600,)),
              (96, 65, 651, 16251, (5,)), (7, 2, 50, 301, (4,)),
              (65, 96, 1601, 24001, (3,)), (3, 20962, 31, 62891, (2,))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,taps,T,lead", GEOMETRIES)
def test_resample_kernel_matches_plain(card, p, q, taps, T, lead):
    rng = np.random.default_rng(T)
    shape = lead + (T,)
    x = torch.from_numpy(
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64)).cuda()
    lpf = fir.resampler_lpf(p, q, taps)
    n0 = cuda_fir.polyphase_resample_cuda.launches
    got = fir.polyphase_resample(x, p, q, lpf)
    assert cuda_fir.polyphase_resample_cuda.launches == n0 + 1
    want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape == lead + (fir.polyphase_output_len(T, p, q),)
    # float32 sums in another order (the bound tests/test_pallas.py:23
    # holds the Pallas kernel to)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


@pytest.mark.cuda
def test_resample_kernel_refuses_bad_input(card):
    lpf = fir.resampler_lpf(65, 96, 961)
    x = torch.zeros(2, 960, dtype=torch.complex64, device="cuda")
    with pytest.raises(ValueError):
        cuda_fir.polyphase_resample_cuda(x[:, ::2], 65, 96, lpf)
    with pytest.raises(TypeError):
        cuda_fir.polyphase_resample_cuda(x.real.contiguous(), 65, 96, lpf)


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,taps,T", [(65, 96, 961, 24000),
                                        (96, 65, 651, 16250)])
def test_resample_kernel_is_deterministic(card, p, q, taps, T):
    """No atomics and a fixed order of sums: two launches on one input
    give the same bits."""
    rng = np.random.default_rng(p)
    x = torch.from_numpy((rng.standard_normal((64, T))
                          + 1j * rng.standard_normal((64, T))
                          ).astype(np.complex64)).cuda()
    lpf = fir.resampler_lpf(p, q, taps)
    a = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
    b = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_resample_kernel_takes_unaligned_rows(card):
    """A contiguous view that starts one sample into its storage: every
    row start is off the 16-byte grid, so the slab copies and the stores
    take their 8-byte paths."""
    p, q, taps, T = 65, 96, 961, 3001
    rng = np.random.default_rng(7)
    base = torch.from_numpy((rng.standard_normal(4 * T + 1)
                             + 1j * rng.standard_normal(4 * T + 1)
                             ).astype(np.complex64)).cuda()
    x = base[1:].view(4, T)
    lpf = fir.resampler_lpf(p, q, taps)
    got = cuda_fir.polyphase_resample_cuda(x, p, q, lpf)
    want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())
