"""PyTorch port: the norm kernels' route pickers, on the CPU.

``ops/norms.py::rms_route`` decides from the width, the dtype and the data
pointers alone whether a call takes the vectorised kernels (a warp per
row, 16-byte loads) or the general ones; ``ln_route`` sends the LayerNorm
forward's rows wider than the vectorised cap to the staged kernel where
four of its row buffers fit in shared memory, else to the held one, and
the others by the same rule.  Both are pure Python, so their rules are held
here without a card; ``tests/test_torch_cuda.py`` checks on the card that
each route's launch counter moves as it says.
"""

import os
import re

import pytest
import torch

from ps_slm_tpu_torch import _build
from ps_slm_tpu_torch.ops import norms

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = 1 << 20   # a 16-byte-aligned address


@pytest.mark.parametrize("d,dtype,route", [
    (1536, BF16, "vec"),      # the LLM's width, 6 chunks a lane
    (1544, BF16, "vec"),      # a multiple of 8, not of 256: lanes past the end idle
    (24, BF16, "vec"),        # 48-byte rows: 3 lanes work
    (560, BF16, "vec"),
    (8, BF16, "vec"),         # one chunk
    (1792, BF16, "vec"),      # the cap, 3 584 bytes
    (1800, BF16, "general"),  # past the cap
    (1538, BF16, "general"),  # not a whole number of 16-byte chunks
    (263, BF16, "general"),
    (25055, BF16, "general"),
    (30011, BF16, "general"),
    (896, F32, "vec"),        # fp32 cap, 3 584 bytes
    (900, F32, "general"),
    (560, F32, "vec"),
    (24, F32, "vec"),
    (1536, F32, "general"),   # 6 144-byte rows
    (6, F32, "general"),      # 24 bytes
])
def test_route_by_width_and_dtype(d, dtype, route):
    assert norms.rms_route(d, dtype, (ALIGNED, ALIGNED + 4096, ALIGNED + 8192)) == route


@pytest.mark.parametrize("offset,route", [(0, "vec"), (16, "vec"), (32, "vec"),
                                          (2, "general"), (8, "general"), (4, "general")])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_route_by_pointer_alignment(offset, route, which):
    """Any one of x, w, g and dx off the 16-byte grid sends the call to the
    general route."""
    ptrs = [ALIGNED] * 4
    ptrs[which] += offset
    assert norms.rms_route(1536, BF16, ptrs) == route


def test_route_of_tensors_at_an_odd_storage_offset():
    """A contiguous view one element into its storage is not aligned."""
    n, d = 4, 1536
    base = torch.zeros(n * d + 8, dtype=BF16)
    x = base[1:1 + n * d].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    w = torch.ones(d, dtype=BF16)
    assert norms.rms_route(d, BF16, (x.data_ptr(), w.data_ptr())) == "general"
    x0 = base[8:8 + n * d].view(n, d)
    assert norms.rms_route(d, BF16, (x0.data_ptr(), w.data_ptr())) == "vec"


def test_route_cap_matches_the_kernel_source():
    """VEC_ROW_BYTES is the CUDA source's VEC_MAX_CHUNKS 16-byte chunks for
    each of a warp's 32 lanes, and its chunk dispatch covers 1..that."""
    with open(os.path.join(_build.CSRC, "norms.cu")) as f:
        src = f.read()
    max_chunks = int(re.search(r"constexpr int VEC_MAX_CHUNKS = (\d+);", src).group(1))
    assert norms.VEC_ROW_BYTES == max_chunks * 32 * 16
    cases = {int(c) for c in re.findall(r"case (\d+): f\(std::integral_constant<int, \1>", src)}
    assert cases == set(range(1, max_chunks + 1))


@pytest.mark.parametrize("weight_grad", [True, False])
def test_cpu_wrappers_take_the_plain_versions_and_count_no_route(weight_grad):
    """On the CPU the wrappers run the plain versions: no launch, no route
    counted; ``weight_grad=False`` gives dx alone and dw None."""
    g_ = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, generator=g_)
    w = 1 + 0.1 * torch.randn(64, generator=g_)
    g = torch.randn(5, 64, generator=g_)
    before = (dict(norms.rms_norm_fwd.routes), dict(norms.rms_norm_bwd.routes),
              norms.rms_norm_fwd.launches, norms.rms_norm_bwd.launches)
    y, rstd = norms.rms_norm_fwd(x, w)
    dx, dw = norms.rms_norm_bwd(x, w, rstd, g, weight_grad=weight_grad)
    assert before == (norms.rms_norm_fwd.routes, norms.rms_norm_bwd.routes,
                      norms.rms_norm_fwd.launches, norms.rms_norm_bwd.launches)
    want_dx, want_dw = norms.rms_norm_bwd_ref(x, w, rstd, g)
    torch.testing.assert_close(dx, want_dx, rtol=0, atol=0)
    if weight_grad:
        torch.testing.assert_close(dw, want_dw, rtol=0, atol=0)
    else:
        assert dw is None


@pytest.mark.parametrize("d,dtype,route", [
    (512, BF16, "vec"),       # the encoder's width, 2 chunks a lane
    (560, BF16, "vec"),       # the encoder's input width, 3 chunks a lane
    (1784, BF16, "vec"),      # one chunk under the cap
    (1792, BF16, "vec"),      # the cap, 3 584 bytes
    (1800, BF16, "staged"),   # one chunk past the cap
    (25055, BF16, "staged"),  # the projector's norm over the CTC posterior
    (28792, BF16, "staged"),  # the widest row whose four buffers fit
    (28793, BF16, "held"),
    (30011, BF16, "held"),
    (263, BF16, "general"),   # not a whole number of 16-byte chunks
    (1538, BF16, "general"),
    (512, F32, "vec"),        # 4 chunks a lane
    (560, F32, "vec"),        # 5 chunks a lane
    (892, F32, "vec"),        # one chunk under the fp32 cap
    (896, F32, "vec"),        # the fp32 cap
    (900, F32, "staged"),     # one chunk past it
    (1536, F32, "staged"),
    (14396, F32, "staged"),   # the widest fp32 row whose four buffers fit
    (14397, F32, "held"),
    (25055, F32, "held"),
    (6, F32, "general"),      # 24 bytes
])
def test_ln_route_by_width_and_dtype(d, dtype, route):
    assert norms.ln_route(d, dtype, (ALIGNED, ALIGNED + 4096, ALIGNED + 8192, ALIGNED + 12288)) == route


@pytest.mark.parametrize("offset,route", [(0, "vec"), (16, "vec"), (2, "general"), (8, "general")])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_ln_route_by_pointer_alignment(offset, route, which):
    """Any one of x, w, b and y off the 16-byte grid sends a 512-wide call
    to the general route; the staged and held routes take any alignment."""
    ptrs = [ALIGNED] * 4
    ptrs[which] += offset
    assert norms.ln_route(512, BF16, ptrs) == route
    assert norms.ln_route(25055, BF16, ptrs) == "staged"
    assert norms.ln_route(30011, BF16, ptrs) == "held"


def test_ln_route_of_tensors_at_an_odd_storage_offset():
    """A contiguous view one element into its storage is not aligned: the
    encoder's width leaves the vectorised route, the projector's keeps the
    staged one."""
    w512, w25055 = torch.ones(512, dtype=BF16), torch.ones(25055, dtype=BF16)
    for d, w, aligned, odd in ((512, w512, "vec", "general"), (25055, w25055, "staged", "staged")):
        base = torch.zeros(3 * d + 8, dtype=BF16)
        x = base[1:1 + 3 * d].view(3, d)
        assert x.is_contiguous() and x.data_ptr() % 16 == 2
        ptrs = (w.data_ptr(), w.data_ptr(), base.data_ptr())
        assert norms.ln_route(d, BF16, (x.data_ptr(), *ptrs)) == odd
        assert norms.ln_route(d, BF16, (base[8:].data_ptr(), *ptrs)) == aligned


def test_ln_wide_route_matches_the_kernel_source():
    """The staged and held entry points refuse the rows the vectorised cap
    takes, by the same VEC_ROW_BYTES; ``ln_route``'s fit rule for the
    staged route is the source's (ln_staged_fits: four ln_stage_bytes
    buffers in DYN_SMEM_MAX), and the held entry point refuses the rows it
    takes; the LayerNorm forward's vectorised launch is the shared kernel
    template with its LayerNorm flag."""
    with open(os.path.join(_build.CSRC, "norms.cu")) as f:
        src = f.read()
    assert "constexpr int VEC_ROW_BYTES = VEC_MAX_CHUNKS * 32 * 16;" in src
    smem = re.search(r"constexpr int DYN_SMEM_MAX = (\d+) \* (\d+);", src)
    assert norms.LN_STAGED_SMEM_BYTES == int(smem.group(1)) * int(smem.group(2))
    assert "return (row_bytes + 15 + 15) / 16 * 16;" in src
    assert ("return row_bytes > VEC_ROW_BYTES && 4 * ln_stage_bytes(row_bytes) <= DYN_SMEM_MAX;"
            in src)
    staged = src[src.index('extern "C" int ps_layer_norm_fwd_staged'):]
    held = src[src.index('extern "C" int ps_layer_norm_fwd_held'):]
    assert "if (!ln_staged_fits(row_bytes)) return;" in staged[:staged.index("<<<")]
    assert ("if (row_bytes <= VEC_ROW_BYTES || ln_staged_fits(row_bytes)) return;"
            in held[:held.index("<<<")])
    assert "norm_fwd_vec_kernel<T, NCH, true>" in src
    assert "norm_fwd_vec_kernel<T, NCH, false>" in src


def test_cpu_layer_norm_takes_the_plain_version_and_counts_no_route():
    g_ = torch.Generator().manual_seed(1)
    x = torch.randn(5, 560, generator=g_)
    w = 1 + 0.1 * torch.randn(560, generator=g_)
    b = 0.1 * torch.randn(560, generator=g_)
    before = (dict(norms.layer_norm_fwd.routes), norms.layer_norm_fwd.launches)
    got = norms.layer_norm_fwd(x, w, b)
    assert before == (norms.layer_norm_fwd.routes, norms.layer_norm_fwd.launches)
    for a, e in zip(got, norms.layer_norm_ref(x, w, b)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
