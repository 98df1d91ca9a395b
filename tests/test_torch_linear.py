"""The split-bf16 GEMM's route and arithmetic on the CPU
(``vqatpu_torch.kernels.linear``): which products take the kernel and which
stay on ``F.linear``, ``linear_f32``'s forward and both gradients against
``F.linear``'s autograd, and the six-product scheme's error against
float64, at most twice a plain float32 matmul's.  The kernel itself runs
only on the card: ``tests/test_torch_linear_cuda.py``."""

import pytest
import torch
import torch.nn.functional as F

from vqatpu_torch.kernels import linear as L
from vqatpu_torch.kernels import trilinear as K
from vqatpu_torch.ops.linear import WNLinear

# (rows, N, K) of the cells' float32 products through WNLinear and the fused
# tucker GEMM, with the route's verdict (at least 48 output tiles of 128 x
# 128, K and N multiples of 128): the v-, q- and a-side tuckers, the
# projections and the first classifier layer of CTI (B=1024, V=50, Q=12,
# A=3) take the kernel, as do the Visual7W grid's tuckers (256 rows,
# V=196, Q=12, A=6); its 256-row products do not.
CELL_PRODUCTS = [
    ((51200, 512, 2048), True),    # CTI att.tc.v_tucker
    ((51200, 1024, 2048), True),   # CTI t_net{0,1}.v_tucker
    ((50176, 512, 2048), True),    # grid
    ((50176, 1024, 2048), True),
    ((51200, 1536, 2048), True),   # fused_v_tucker's three nets at once
    ((12288, 512, 1024), True),    # CTI q_tucker
    ((12288, 1024, 1024), True),
    ((3072, 1024, 1024), True),    # CTI a_tucker; the grid's q_tucker
    ((1536, 1024, 1024), True),    # the grid's a_tucker: 96 tiles
    ((1536, 512, 1024), True),     # the grid's att a_tucker: 48 tiles
    ((1024, 1024, 1024), True),    # CTI q_prj / a_prj: 64 tiles
    ((1024, 2048, 1024), True),    # CTI classifier l0
    ((1408, 512, 1024), False),    # below the rule's edge: 44 tiles
    ((1024, 512, 1024), False),    # 32 tiles
    ((256, 1024, 1024), False),    # the grid's 256-row products
    ((256, 2048, 1024), False),
    ((1024, 3129, 2048), False),   # classifier l1: N off the tile
    ((51200, 1000, 2048), False),  # N off the tile
    ((51200, 1024, 2000), False),  # K off the tile
]


@pytest.mark.parametrize("shape,takes", CELL_PRODUCTS,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_route_rule_at_the_cells_products(shape, takes):
    assert L.fits_kernel(*shape) is takes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_bf16_stay_on_f_linear(dtype):
    """The CPU never takes the kernel, nor does bf16 compute, whatever the
    shape; the routed product is ``F.linear``'s, bit for bit."""
    x = torch.randn(2, 64, 128).to(dtype)
    w = torch.randn(128, 128).to(dtype)
    assert not L.takes_kernel(x, w)
    assert torch.equal(L.routed_linear(x, w), F.linear(x, w))


def test_wnlinear_on_the_cpu_launches_nothing():
    K.reset_launches()
    layer = WNLinear(128, 256)
    layer(torch.randn(3, 5, 128)).sum().backward()
    assert sum(K.launches.values()) == 0


@pytest.mark.parametrize("x_grad", [False, True])
@pytest.mark.parametrize("shape", [(2, 37, 96), (130, 200)])
def test_linear_f32_matches_f_linear_autograd(shape, x_grad):
    """Forward, input gradient (where ``x`` needs one) and weight gradient
    of ``linear_f32`` against ``F.linear``'s autograd, within float32's
    rounding of the largest term."""
    g = torch.Generator().manual_seed(7)
    K = shape[-1]
    x = torch.randn(*shape, generator=g).requires_grad_(x_grad)
    w = (torch.randn(72, K, generator=g) / K ** 0.5).requires_grad_(True)
    cot = torch.randn(*shape[:-1], 72, generator=g)
    got = L.linear_f32(x, w)
    got_grads = torch.autograd.grad(got, [x, w] if x_grad else [w], cot)
    want = F.linear(x, w)
    want_grads = torch.autograd.grad(want, [x, w] if x_grad else [w], cot)
    for a, b in zip((got, *got_grads), (want, *want_grads)):
        assert a.shape == b.shape and a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("M,N,K", [(33, 17, 96), (130, 72, 200),
                                   (257, 129, 1000), (64, 128, 2048)])
def test_six_products_keep_float32_accuracy(M, N, K):
    """The kernel's scheme (bf16-valued float32 terms through a float32
    matmul, ragged sizes included): its largest error against float64 is
    at most twice a plain float32 matmul's."""
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g)
    b = torch.randn(N, K, generator=g) * 0.03
    ref = a.double() @ b.double().T
    err_split = (L.split_bf16x6_mm(a, b) - ref).abs().max().item()
    err_plain = (a @ b.T - ref).abs().max().item()
    assert 0 < err_split <= 2 * err_plain


def test_linear_f32_refuses_other_dtypes_and_shapes():
    with pytest.raises(TypeError, match="float32"):
        L.linear_f32(torch.randn(4, 8).double(), torch.randn(4, 8).double())
    with pytest.raises(ValueError, match="expected"):
        L.linear_f32(torch.randn(4, 8), torch.randn(4, 6))
