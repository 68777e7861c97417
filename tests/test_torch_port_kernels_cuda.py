"""The port's CUDA flash-attention kernels against their plain versions, on
the card. Marked `cuda`: without a CUDA device every test here skips. Run
them on a GPU machine with

    python -m pytest tests/test_torch_port_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

from leco_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# bf16 outputs from a reassociating online softmax: the bf16 bound of
# tests/test_flash_attention.py; gradients relative to their own size
ATOL_O, ATOL_LSE, RTOL_GRAD = 2e-2, 1e-3, 2e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


@pytest.mark.parametrize("nq,nk,d", [(256, 256, 40), (300, 300, 64), (1024, 1024, 80),
                                     (256, 256, 160), (256, 77, 40)])
def test_kernels_match_plain(device, nq, nk, d):
    gen = torch.Generator(device).manual_seed(0)
    q, g = _rand(gen, (4, nq, d), device), _rand(gen, (4, nq, d), device)
    k, v = _rand(gen, (4, nk, d), device), _rand(gen, (4, nk, d), device)
    scale = d**-0.5
    before = fa.launch_counts()
    o, lse = fa.attn_fwd(q, k, v, scale)
    o_ref, lse_ref = fa.attn_fwd_plain(q, k, v, scale)
    delta = (g.float() * o_ref.float()).sum(-1)
    dq = fa.attn_bwd_dq(q, k, v, g, lse_ref, delta, scale)
    dk, dv = fa.attn_bwd_dkv(q, k, v, g, lse_ref, delta, scale)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.launch_counts().items()} == {
        "attn_fwd": 1, "attn_bwd_dq": 1, "attn_bwd_dkv": 1}
    assert (o.float() - o_ref.float()).abs().max() <= ATOL_O
    assert (lse - lse_ref).abs().max() <= ATOL_LSE
    refs = (fa.attn_bwd_dq_plain(q, k, v, g, lse_ref, delta, scale),
            *fa.attn_bwd_dkv_plain(q, k, v, g, lse_ref, delta, scale))
    for got, ref in zip((dq, dk, dv), refs):
        assert (got.float() - ref.float()).abs().max() <= RTOL_GRAD * ref.float().abs().max()


def test_autograd_matches_plain_autograd(device):
    gen = torch.Generator(device).manual_seed(1)
    q, k, v = (_rand(gen, (2, 256, 2, 40), device).requires_grad_() for _ in range(3))
    (fa.flash_attention(q, k, v, 40**-0.5).float() ** 2).sum().backward()
    got = [t.grad.float() for t in (q, k, v)]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * 40**-0.5
    out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vf)
    (out**2).sum().backward()
    for a, b in zip(got, (qf.grad, kf.grad, vf.grad)):
        assert (a - b).abs().max() <= RTOL_GRAD * b.abs().max()


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    q = torch.zeros((2, 256, 40), device=device)
    with pytest.raises(TypeError):
        fa.attn_fwd(q, q, q, 0.1)  # fp32 is not a kernel dtype
    q = torch.zeros((2, 256, 48), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.attn_fwd(q, q, q, 0.1)  # head dim 48 has no kernel
    q = torch.zeros((2, 40, 256), device=device, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        fa.attn_fwd(q, q, q, 0.1)  # not contiguous
