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

GEOMETRIES = [(65, 96, 961, 24000), (96, 65, 651, 16250),
              (3, 200, 31, 1000), (7, 2, 50, 300)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,taps,T", GEOMETRIES)
def test_resample_kernel_matches_plain(card, p, q, taps, T):
    rng = np.random.default_rng(T)
    x = torch.from_numpy(
        (rng.standard_normal((3, 2, T)) + 1j * rng.standard_normal((3, 2, T))
         ).astype(np.complex64)).cuda()
    lpf = fir.resampler_lpf(p, q, taps)
    n0 = cuda_fir.polyphase_resample_cuda.launches
    got = fir.polyphase_resample(x, p, q, lpf)
    assert cuda_fir.polyphase_resample_cuda.launches == n0 + 1
    want = cuda_fir.polyphase_resample_plain(x, p, q, lpf)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape == (3, 2, fir.polyphase_output_len(T, p, q))
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
