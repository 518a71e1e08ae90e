"""The hand-written CUDA flash-forward kernel against its plain PyTorch version,
at small shapes. Needs an NVIDIA GPU with nvcc (marked ``cuda``; skips
elsewhere). Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import numpy as np
import pytest
import torch

from osufusion_tpu_torch.ops import flash_attention as fa
from osufusion_tpu_torch.ops.rope import rope_tables

# bf16 output of a softmax-weighted mean of N(0, 1) values: one bf16 rounding
# of o (~2^-9 relative) plus bf16 q/p operands inside the kernel
TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, T, H, seed, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, torch.bfloat16)
               for s in ((B, T, H, 64), (B, T, 1, 64), (B, T, 1, 64)))
    return q, k, v, rope_tables(T, 64, scale_base=float(min(T, 512)), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,T,H,window",
    [(2, 1024, 16, 256), (1, 1000, 16, 128), (2, 512, 3, 96), (1, 384, 16, None), (2, 200, 5, None), (1, 256, 16, 512)],
)
def test_flash_fwd_matches_plain(cuda, B, T, H, window):
    q, k, v, rope = _inputs(B, T, H, seed=T + H, device=cuda)
    before = fa.flash_fwd.launches
    out = fa.flash_attention(q, k, v, window, rope)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), window, rope)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = (out.float() - ref).abs().max().item()
    assert err < TOL, f"max abs err {err}"


@pytest.mark.cuda
def test_flash_fwd_rejects_what_it_does_not_take(cuda):
    q, k, v, rope = _inputs(1, 128, 4, seed=0, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q.float(), k.float(), v.float(), None, rope)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.cat([k, k], dim=2), torch.cat([v, v], dim=2), None, rope)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k[:, :, 0], v[:, ::2, 0], *rope, -1, 0.125)
