"""The split-bf16 GEMM (``csrc/linear_f32.cu``) on the card, at the cells'
shapes and at ragged edges: its forward, weight gradient and input gradient
against float64, at most twice cuBLAS float32's error; the weight gradient
bitwise the same over two runs; ``routed_linear`` under autograd: its
values and the launch counter.  Every case needs a
card and skips without one.  On the card, where ``tests/conftest.py``
cannot import JAX (this file imports none):

    python3 -m pytest --noconftest tests/test_torch_linear_cuda.py -q
"""

import pytest
import torch

from vqatpu_torch.kernels import linear as L
from vqatpu_torch.kernels import trilinear as K
from vqatpu_torch.numerics import require_f32_math

# (M, N, K): the v-side tuckers of both cells, then ragged M, N and K
SHAPES = [(51200, 512, 2048), (51200, 1024, 2048), (50176, 512, 2048),
          (50176, 1024, 2048), (1000, 196, 2048), (777, 260, 100),
          (130, 1024, 2048), (4096, 132, 516)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    require_f32_math()
    return torch.device("cuda")


def operands(M, N, K, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, K, device=dev, generator=g).relu()  # features are >= 0
    w = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
    dy = torch.randn(M, N, device=dev, generator=g) / M ** 0.5
    return x, w, dy


def assert_within_twice_cublas(got, cublas, ref, what):
    err = (got.double() - ref).abs().max().item()
    err_cublas = (cublas.double() - ref).abs().max().item()
    assert err <= 2 * err_cublas, (what, err, err_cublas)


def products(x, w, dy):
    """(y, dw, dx) through the kernel's three instances."""
    return (L._gemm("forward", x, w, *x.shape[:1], *w.shape),
            L._gemm("wgrad", dy, x, *x.shape[:1], *w.shape),
            L._gemm("dgrad", dy, w, *x.shape[:1], *w.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", SHAPES)
def test_kernel_against_float64_within_twice_cublas(cuda, M, N, K):
    x, w, dy = operands(M, N, K, cuda, M + N + K)
    y, dw, dx = products(x, w, dy)
    xd, wd, dyd = x.double(), w.double(), dy.double()
    assert_within_twice_cublas(y, x @ w.T, xd @ wd.T, "forward")
    assert_within_twice_cublas(dw, dy.T @ x, dyd.T @ xd, "weight gradient")
    assert_within_twice_cublas(dx, dy @ w, dyd @ wd, "input gradient")


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(51200, 512, 2048), (50176, 1024, 2048)])
def test_weight_gradient_is_bitwise_repeatable(cuda, M, N, K):
    x, w, dy = operands(M, N, K, cuda, 3)
    first = L._gemm("wgrad", dy, x, M, N, K)
    again = L._gemm("wgrad", dy, x, M, N, K)
    assert torch.equal(first, again)


def gemm_launches():
    return {k: K.launches[k]
            for k in ("linear_f32", "linear_f32_wgrad", "linear_f32_dgrad")}


@pytest.mark.cuda
def test_routed_linear_launches_the_kernel_with_autograd(cuda):
    """A v-tucker-sized product with a weight gradient and no input
    gradient: one forward and one weight-gradient launch; with an input
    gradient, one more; below the rule, none.  The output and both
    gradients within twice cuBLAS float32's error against float64
    (``F.linear``'s autograd) and within twice cuBLAS's distance from the
    plain version; the weight gradient the same bits both times."""
    x, w, dy = operands(51200, 512, 2048, cuda, 5)
    w.requires_grad_(True)
    K.reset_launches()
    (dw_first,) = torch.autograd.grad(L.routed_linear(x, w), [w], dy)
    assert gemm_launches() == {"linear_f32": 1, "linear_f32_wgrad": 1,
                               "linear_f32_dgrad": 0}
    x.requires_grad_(True)
    y = L.routed_linear(x, w)
    dx, dw = torch.autograd.grad(y, [x, w], dy)
    assert gemm_launches() == {"linear_f32": 2, "linear_f32_wgrad": 2,
                               "linear_f32_dgrad": 1}
    assert torch.equal(dw, dw_first)
    y_lib = torch.nn.functional.linear(x, w)
    dx_lib, dw_lib = torch.autograd.grad(y_lib, [x, w], dy)
    x, w = x.detach(), w.detach()
    xd, wd, dyd = x.double(), w.double(), dy.double()
    for got, lib, ref, plain, what in (
            (y, y_lib, xd @ wd.T, L.split_bf16x6_mm(x, w), "output"),
            (dx, dx_lib, dyd @ wd, L.split_bf16x6_mm(dy, w.T.contiguous()),
             "input gradient"),
            (dw, dw_lib, dyd.T @ xd,
             L.split_bf16x6_mm(dy.T.contiguous(), x.T.contiguous()),
             "weight gradient")):
        assert_within_twice_cublas(got.detach(), lib.detach(), ref, what)
        gap = (got.detach() - plain).abs().max().item()
        gap_lib = (lib.detach() - plain).abs().max().item()
        assert gap <= 2 * gap_lib, (what, gap, gap_lib)
    small = x[:1408]  # 44 output tiles of the 48 the rule asks for
    assert not L.takes_kernel(small, w)
    L.routed_linear(small, w)
    assert gemm_launches()["linear_f32"] == 2
