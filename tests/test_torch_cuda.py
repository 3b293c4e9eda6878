"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false (the decision is taken inside the fixture, never at import).  Run on
a machine with an NVIDIA H100:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: fp32 2e-5 (sums in another order); bf16 1e-2 relative and
absolute, one bf16 rounding step of the same fp32 value.
"""

import pytest
import torch

from ps_slm_tpu_torch.ops import flash_attention as fa
from ps_slm_tpu_torch.ops import norms

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [24, 560, 1536, 25055])
def test_norm_kernels_match_plain(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn(37, d, device=dev, generator=g) * 3 + 1).to(dtype)
    w = (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
    b = (0.1 * torch.randn(d, device=dev, generator=g)).to(dtype)
    n0 = norms.layer_norm_fwd.launches
    got = norms.layer_norm_fwd(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm_fwd.launches == n0 + 1
    for g_, r_ in zip(got, norms.layer_norm_ref(x, w, b)):
        torch.testing.assert_close(g_.float(), r_.float(), **TOL[dtype])
    n0 = norms.rms_norm_fwd.launches
    got = norms.rms_norm_fwd(x, w)
    torch.cuda.synchronize()
    assert norms.rms_norm_fwd.launches == n0 + 1
    for g_, r_ in zip(got, norms.rms_norm_ref(x, w)):
        torch.testing.assert_close(g_.float(), r_.float(), **TOL[dtype])


CASES = {
    "encoder": (4, 516, 4, 4, False, [516, 404, 304, 260], None),
    "prefill_left_padded": (4, 543, 12, 2, True, None, [0, 112, 212, 543]),
    "ragged": (2, 70, 2, 1, True, [70, 33], None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel_matches_plain(dev, dtype, case):
    b, s, hq, hkv, causal, lens, starts = CASES[case]
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(b, s, hq, fa.HEAD_DIM, device=dev, generator=g).to(dtype)
    k = torch.randn(b, s, hkv, fa.HEAD_DIM, device=dev, generator=g).to(dtype)
    v = torch.randn(b, s, hkv, fa.HEAD_DIM, device=dev, generator=g).to(dtype)
    pos = torch.arange(s, device=dev)
    if lens is not None:
        mask = pos[None] < torch.tensor(lens, device=dev)[:, None]
    else:
        mask = pos[None] >= torch.tensor(starts, device=dev)[:, None]
    start, end = fa.window_from_mask(mask, b, s, dev)
    n0 = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, start, end, causal=causal, scale=0.088)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, start, end, causal=causal, scale=0.088)
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.float32])


def test_flash_kernel_rejects_other_head_dims(dev):
    q = torch.zeros(1, 4, 2, 64, device=dev)
    win = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, q, q, win, win + 4, causal=False, scale=1.0)
