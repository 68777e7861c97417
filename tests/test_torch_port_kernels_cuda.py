"""The port's CUDA kernels (flash attention: the forward, 3-d and packed,
and the dQ and dK/dV backward pair; the fused conv, GroupNorm-conv,
GroupNorm and GEGLU kernels, the convs' row windows and the GroupNorm's
statistics and apply launches) against their plain versions, on the card.
Marked `cuda`: without a CUDA device every test here skips. Run them on a
GPU machine with

    python -m pytest tests/test_torch_port_kernels_cuda.py -m cuda -q
"""

import pytest
import torch

from leco_tpu_torch import testing
from leco_tpu_torch.ops import conv, geglu, gn_conv
from leco_tpu_torch.ops import flash_attention as fa
from leco_tpu_torch.ops import group_norm as gn

pytestmark = pytest.mark.cuda

# bf16 outputs from a reassociating online softmax: a bf16 ulp of the
# largest output is sound, so O is held to RTOL_O x max|ref| (2.5-5 ulps)
# and never above the bf16 bound of tests/test_flash_attention.py, ATOL_O;
# gradients relative to their own size
ATOL_O, RTOL_O, ATOL_LSE, RTOL_GRAD = 2e-2, 2e-2, 1e-3, 2e-2
# the fused kernels against their plain versions, both bf16 out of fp32
# sums: relative to the largest magnitude of the plain output (a bf16 ulp
# is 2^-8 of the value)
RTOL_FUSED = 1e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


def _o_error_within_limit(o, ref) -> bool:
    ref = ref.float()
    return (o.float() - ref).abs().max() <= min(ATOL_O, RTOL_O * ref.abs().max().item())


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
        "attn_fwd": 1, "attn_bwd_dq": 1, "attn_bwd_dkv": 1, "attn_fwd_packed": 0}
    assert _o_error_within_limit(o, o_ref)
    assert (lse - lse_ref).abs().max() <= ATOL_LSE
    refs = (fa.attn_bwd_dq_plain(q, k, v, g, lse_ref, delta, scale),
            *fa.attn_bwd_dkv_plain(q, k, v, g, lse_ref, delta, scale))
    for got, ref in zip((dq, dk, dv), refs):
        assert (got.float() - ref.float()).abs().max() <= RTOL_GRAD * ref.float().abs().max()


# the forward core (wgmma, TMA): every head dim at Nq not a multiple of its
# 128-row blocks (300, and 384: a 24 x 16 latent), ragged and masked key
# counts (77, 300) against 128- and 64-key tiles, BH 1, and BH 140, more
# blocks than the card has SMs
FWD_CORE_SHAPES = [(bh, nq, nk, d) for d in (40, 64, 80, 160)
                   for bh, nq, nk in ((1, 300, 300), (2, 384, 77), (140, 384, 300),
                                      (3, 1024, 1024))]
# SDXL at 1024 px (every head 64 wide): levels 1 and 2 (4096 and 1024
# tokens) at the inner loop's 2B (10 and 20 heads), the references' 3B and
# the target's B, B = 1
XL_FWD_SHAPES = [(20, 4096, 4096, 64), (40, 1024, 1024, 64), (30, 4096, 4096, 64),
                 (60, 1024, 1024, 64), (10, 4096, 4096, 64), (20, 1024, 1024, 64)]
FWD_CORE_SHAPES += XL_FWD_SHAPES


@pytest.mark.parametrize("bh,nq,nk,d", FWD_CORE_SHAPES)
def test_fwd_core_matches_plain(device, bh, nq, nk, d):
    gen = torch.Generator(device).manual_seed(7)
    q = _rand(gen, (bh, nq, d), device)
    k, v = _rand(gen, (bh, nk, d), device), _rand(gen, (bh, nk, d), device)
    o, lse = fa.attn_fwd(q, k, v, d**-0.5)
    o_ref, lse_ref = fa.attn_fwd_plain(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert o.shape == (bh, nq, d) and lse.shape == (bh, nq)
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert _o_error_within_limit(o, o_ref)
    assert (lse - lse_ref).abs().max() <= ATOL_LSE


# the backward pair (wgmma, TMA): every head dim at Nq not a multiple of the
# dQ kernel's 128-row blocks or the dK/dV kernel's 64- and 32-row query tiles
# (300), a 24 x 16 latent (384), ragged and masked key counts (77, 300)
# against 64-key tiles and 128-key blocks, BH 1, and BH 140, more blocks than
# the card has SMs
BWD_SHAPES = [(bh, nq, nk, d) for d in (40, 64, 80, 160)
              for bh, nq, nk in ((1, 300, 300), (2, 384, 77), (140, 384, 300),
                                 (3, 1024, 1024))]
BWD_SHAPES += [(10, 4096, 4096, 64), (20, 1024, 1024, 64)]  # SDXL's target pass, B = 1


@pytest.mark.parametrize("bh,nq,nk,d", BWD_SHAPES)
def test_bwd_pair_matches_plain_and_repeats_bitwise(device, bh, nq, nk, d):
    gen = torch.Generator(device).manual_seed(8)
    q, g = _rand(gen, (bh, nq, d), device), _rand(gen, (bh, nq, d), device)
    k, v = _rand(gen, (bh, nk, d), device), _rand(gen, (bh, nk, d), device)
    scale = d**-0.5
    o_ref, lse = fa.attn_fwd_plain(q, k, v, scale)
    delta = (g.float() * o_ref.float()).sum(-1)
    before = fa.launch_counts()
    runs = [(fa.attn_bwd_dq(q, k, v, g, lse, delta, scale),
             *fa.attn_bwd_dkv(q, k, v, g, lse, delta, scale)) for _ in range(2)]
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.launch_counts().items()} == {
        "attn_fwd": 0, "attn_bwd_dq": 2, "attn_bwd_dkv": 2, "attn_fwd_packed": 0}
    refs = (fa.attn_bwd_dq_plain(q, k, v, g, lse, delta, scale),
            *fa.attn_bwd_dkv_plain(q, k, v, g, lse, delta, scale))
    for got, again, ref in zip(*runs, refs):
        assert got.shape == ref.shape and got.dtype == torch.bfloat16
        assert torch.isfinite(got.float()).all()
        ref = ref.float()
        assert (got.float() - ref).abs().max() <= RTOL_GRAD * ref.abs().max()
        assert torch.equal(got, again)  # no atomics: two calls give the same bits


DROPPED = 64  # the controls' missing key tile (O, dQ) or query rows (dK, dV)


@pytest.mark.parametrize("bh,n", [(20, 4096), (40, 1024), (10, 4096), (20, 1024)])
def test_xl_shapes_limits_fail_their_controls(device, bh, n):
    """SDXL's level-1 and level-2 shapes (D 64) at the inner 2B and the
    target's B: O, dQ, dK and dV within their limits, and each limit failed
    by the plain version without a key tile (O, dQ) or query rows (dK, dV)."""
    d = 64
    gen = torch.Generator(device).manual_seed(21)
    q, k, v, g = (_rand(gen, (bh, n, d), device) for _ in range(4))
    scale = d**-0.5
    o, _ = fa.attn_fwd(q, k, v, scale)
    o_ref, lse = fa.attn_fwd_plain(q, k, v, scale)
    o_control, _ = fa.attn_fwd_plain(q, k[:, :-DROPPED], v[:, :-DROPPED], scale)
    limit = min(ATOL_O, RTOL_O * o_ref.float().abs().max().item())
    assert (o.float() - o_ref.float()).abs().max() <= limit
    assert (o_control.float() - o_ref.float()).abs().max() > limit
    delta = (g.float() * o_ref.float()).sum(-1)
    got = (fa.attn_bwd_dq(q, k, v, g, lse, delta, scale),
           *fa.attn_bwd_dkv(q, k, v, g, lse, delta, scale))
    refs = (fa.attn_bwd_dq_plain(q, k, v, g, lse, delta, scale),
            *fa.attn_bwd_dkv_plain(q, k, v, g, lse, delta, scale))
    kept = slice(0, n - DROPPED)
    controls = (fa.attn_bwd_dq_plain(q, k[:, :-DROPPED], v[:, :-DROPPED], g, lse, delta, scale),
                *fa.attn_bwd_dkv_plain(q[:, kept], k, v, g[:, kept], lse[:, kept],
                                       delta[:, kept], scale))
    for got_, ref, control in zip(got, refs, controls):
        grad_limit = RTOL_GRAD * ref.float().abs().max()
        assert (got_.float() - ref.float()).abs().max() <= grad_limit
        assert (control.float() - ref.float()).abs().max() > grad_limit


def test_autograd_matches_plain_autograd_at_sd21_level0(device):
    """FlashAttention3D (the forward and both backward kernels) against
    fp32 autograd through plain attention at SD2.1's level 0, batch 2."""
    gen = torch.Generator(device).manual_seed(9)
    q, k, v = (_rand(gen, (2, 4096, 5, 64), device).requires_grad_() for _ in range(3))
    (fa.flash_attention(q, k, v, 64**-0.5).float() ** 2).sum().backward()
    got = [t.grad.float() for t in (q, k, v)]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * 64**-0.5
    out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), vf)
    (out**2).sum().backward()
    for a, b in zip(got, (qf.grad, kf.grad, vf.grad)):
        assert (a - b).abs().max() <= RTOL_GRAD * b.abs().max()


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
    q = torch.zeros(2 * 256 * 40 + 1, device=device, dtype=torch.bfloat16)[1:].view(2, 256, 40)
    with pytest.raises(ValueError):
        fa.attn_fwd(q, q, q, 0.1)  # off the 16-byte boundary that TMA needs


@pytest.mark.parametrize("b,nq,nk,heads,d", [(2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64),
                                             (2, 256, 256, 5, 64), (2, 300, 300, 8, 40),
                                             (1, 256, 300, 2, 80), (1, 256, 256, 4, 160),
                                             (1, 1024, 77, 10, 64), (2, 384, 300, 5, 64),
                                             (3, 300, 77, 8, 40), (1, 1024, 1024, 8, 80),
                                             (2, 256, 300, 5, 160)])
def test_packed_kernel_matches_plain(device, b, nq, nk, heads, d):
    """(B, N, heads * D) in place: ragged N, every head dim, and a masked
    key count; through the same kernel and tensor-map scheme as the 3-d
    route, so its O is the 3-d route's bit for bit."""
    gen = torch.Generator(device).manual_seed(6)
    c = heads * d
    q = _rand(gen, (b, nq, c), device)
    k, v = _rand(gen, (b, nk, c), device), _rand(gen, (b, nk, c), device)
    before = fa.launch_counts()
    o = fa.attn_fwd_packed(q, k, v, heads, d**-0.5)
    torch.cuda.synchronize()
    assert {n: c - before[n] for n, c in fa.launch_counts().items()} == {
        "attn_fwd": 0, "attn_bwd_dq": 0, "attn_bwd_dkv": 0, "attn_fwd_packed": 1}
    ref = fa.attn_fwd_packed_plain(q, k, v, heads, d**-0.5)
    assert o.shape == ref.shape == (b, nq, c) and o.dtype == torch.bfloat16
    assert _o_error_within_limit(o, ref)
    # the same attention through the 3-d kernel, head by head
    o3, _ = fa.attn_fwd(*(t.reshape(b, -1, heads, d).transpose(1, 2).reshape(b * heads, -1, d)
                          .contiguous() for t in (q, k, v)), d**-0.5)
    assert torch.equal(o3.reshape(b, heads, nq, d).transpose(1, 2).reshape(b, nq, c), o)


def test_packed_wrapper_refuses_what_the_kernel_does_not_take(device):
    q = torch.zeros((2, 256, 320), device=device)
    with pytest.raises(TypeError):
        fa.attn_fwd_packed(q, q, q, 5, 0.1)  # fp32 is not a kernel dtype
    q = q.bfloat16()
    with pytest.raises(ValueError):
        fa.attn_fwd_packed(q, q, q, 10, 0.1)  # head dim 32 has no kernel
    with pytest.raises(ValueError):  # not contiguous
        fa.attn_fwd_packed(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, 5, 0.1)


def _close(got, ref, control=None):
    """got within RTOL_FUSED x max|ref| of ref; a `control` (what a faulty
    kernel computes, `testing.*_control`) must fail that limit."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got.float()).all()
    limit = RTOL_FUSED * ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= limit, err
    if control is not None:
        assert (control.float() - ref.float()).abs().max().item() > limit


def _bf16(gen, shape, device, scale=1.0):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(torch.bfloat16)


@pytest.mark.parametrize("b,cin,h,w,cout", [(2, 640, 64, 64, 640), (1, 1280, 16, 16, 1280),
                                            (1, 20, 5, 7, 24)])
def test_conv3x3_and_its_dx_match_plain(device, b, cin, h, w, cout):
    gen = torch.Generator(device).manual_seed(2)
    x = _bf16(gen, (b, cin, h, w), device)
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    before = conv.conv3x3_gemm.launches
    control = testing.conv3x3_control(x, wt, bias) if cin > testing.CONTROL_DROPPED else None
    _close(conv.conv3x3_gemm(x, wt, bias), conv.conv3x3_gemm_plain(x, wt, bias), control)
    g = _bf16(gen, (b, cout, h, w), device)
    xg = x.clone().requires_grad_()
    conv.conv3x3(xg, wt, bias).backward(g)
    torch.cuda.synchronize()
    assert conv.conv3x3_gemm.launches - before == 3
    _close(xg.grad, conv.conv3x3_gemm_plain(g, conv.flip_weight(wt)))


@pytest.mark.parametrize("b,cin,h,w,cout", [(2, 320, 64, 64, 320), (1, 2560, 16, 16, 1280),
                                            (3, 1920, 32, 32, 640), (1, 20, 5, 7, 24)])
def test_gnconv3x3_matches_plain(device, b, cin, h, w, cout):
    gen = torch.Generator(device).manual_seed(3)
    x = _bf16(gen, (b, cin, h, w), device)
    groups = 4 if cin % 32 else 32
    a, s = gn_conv.affine_from_gn(x, torch.ones(cin, device=device), torch.zeros(cin, device=device),
                                  torch.randn((b, cin), generator=gen, device=device), groups, 1e-5)
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    before = gn_conv.gnconv3x3.launches
    got = gn_conv.gnconv3x3(x, a, s, wt, bias)
    torch.cuda.synchronize()
    assert gn_conv.gnconv3x3.launches - before == 1
    _close(got, gn_conv.gnconv3x3_plain(x, a, s, wt, bias),
           testing.gnconv3x3_control(x, a, s, wt, bias))


# the conv core (wgmma, TMA): every conv and GroupNorm-conv shape of
# chip_smoke (SD1.5 at 512 px), then W 12 (SD2.1's level 3 at 768 px) and W
# 4 (the fill route: W % 8 != 0), a ragged Cin (192), and B 1 and 3
CONV_CORE_SHAPES = [
    (2, 1280, 16, 16, 1280), (2, 1280, 32, 32, 1280), (2, 640, 64, 64, 640),
    (3, 640, 64, 64, 640), (2, 192, 16, 16, 320), (2, 320, 12, 12, 320),
    (1, 128, 4, 4, 128), (3, 192, 12, 12, 128), (1, 320, 8, 8, 320),
    # SDXL at 1024 px: level 0 (W 128) and the widest level-2 up conv
    (2, 320, 128, 128, 320), (2, 2560, 32, 32, 1280),
]
CONV_DX_CORE_SHAPES = [(1, 1280, 16, 16, 1280), (1, 1280, 32, 32, 1280), (1, 640, 64, 64, 640),
                       (1, 320, 128, 128, 320)]
GNCONV_CORE_SHAPES = [
    (2, 320, 64, 64, 320), (2, 960, 64, 64, 320), (2, 640, 64, 64, 320),
    (2, 320, 32, 32, 640), (2, 640, 32, 32, 640), (2, 1920, 32, 32, 640),
    (2, 1280, 32, 32, 640), (2, 960, 32, 32, 640), (2, 640, 16, 16, 1280),
    (2, 1280, 16, 16, 1280), (2, 2560, 16, 16, 1280), (2, 1920, 16, 16, 1280),
    (2, 1280, 8, 8, 1280), (2, 2560, 8, 8, 1280), (3, 320, 64, 64, 320),
    (1, 320, 64, 64, 320), (2, 320, 12, 12, 320), (1, 128, 4, 4, 128),
    (2, 192, 16, 16, 320), (3, 640, 12, 12, 640),
    # SDXL's resnet convs at 1024 px: level 0 (W 128, its up block's 960 and
    # 640 inputs), level 1 and level 2 (the up block's 2560)
    (2, 320, 128, 128, 320), (2, 960, 128, 128, 320), (2, 640, 128, 128, 320),
    (2, 640, 64, 64, 640), (2, 2560, 32, 32, 1280),
]


def _gn_affine(gen, x, device):
    b, cin = x.shape[:2]
    return gn_conv.affine_from_gn(
        x, 1 + 0.1 * torch.randn((cin,), generator=gen, device=device),
        0.1 * torch.randn((cin,), generator=gen, device=device),
        torch.randn((b, cin), generator=gen, device=device), 32 if cin % 32 == 0 else 4, 1e-5)


@pytest.mark.parametrize("b,cin,h,w,cout", CONV_CORE_SHAPES)
def test_conv_core_matches_plain(device, b, cin, h, w, cout):
    gen = torch.Generator(device).manual_seed(10)
    x = _bf16(gen, (b, cin, h, w), device)
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    before = conv.conv3x3_gemm.launches
    got = conv.conv3x3_gemm(x, wt, bias)
    torch.cuda.synchronize()
    assert conv.conv3x3_gemm.launches - before == 1
    _close(got, conv.conv3x3_gemm_plain(x, wt, bias), testing.conv3x3_control(x, wt, bias))
    assert torch.equal(conv.conv3x3_gemm(x, wt, bias), got)  # two calls, the same bits


@pytest.mark.parametrize("b,c,h,w,cout", CONV_DX_CORE_SHAPES)
def test_conv_core_dx_matches_plain(device, b, c, h, w, cout):
    """dx: the conv of g with the flipped weights, flipped in the repack."""
    gen = torch.Generator(device).manual_seed(11)
    g = _bf16(gen, (b, c, h, w), device)
    wt = _bf16(gen, (c, cout, 3, 3), device, (9 * c) ** -0.5)  # the forward conv's OIHW
    flipped = conv.flip_weight(wt)
    got = conv.conv3x3_gemm(g, wt, flip=True)
    _close(got, conv.conv3x3_gemm_plain(g, flipped), testing.conv3x3_control(g, flipped))
    assert torch.equal(got, conv.conv3x3_gemm(g, flipped))


@pytest.mark.parametrize("b,cin,h,w,cout", GNCONV_CORE_SHAPES)
def test_gnconv_core_matches_plain(device, b, cin, h, w, cout):
    gen = torch.Generator(device).manual_seed(12)
    x = _bf16(gen, (b, cin, h, w), device)
    a, s = _gn_affine(gen, x, device)
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    before = gn_conv.gnconv3x3.launches
    got = gn_conv.gnconv3x3(x, a, s, wt, bias)
    torch.cuda.synchronize()
    assert gn_conv.gnconv3x3.launches - before == 1
    _close(got, gn_conv.gnconv3x3_plain(x, a, s, wt, bias),
           testing.gnconv3x3_control(x, a, s, wt, bias))
    assert torch.equal(gn_conv.gnconv3x3(x, a, s, wt, bias), got)  # the same bits


@pytest.mark.parametrize("b,cin,h,w,cout", [(2, 320, 64, 64, 320), (2, 640, 32, 32, 640),
                                            (2, 1280, 8, 8, 1280), (2, 320, 12, 12, 320)])
def test_gnconv_core_without_silu(device, b, cin, h, w, cout):
    gen = torch.Generator(device).manual_seed(13)
    x = _bf16(gen, (b, cin, h, w), device)
    a, s = _gn_affine(gen, x, device)
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    _close(gn_conv.gnconv3x3(x, a, s, wt, bias, with_silu=False),
           gn_conv.gnconv3x3_plain(x, a, s, wt, bias, with_silu=False),
           testing.gnconv3x3_control(x, a, s, wt, bias, with_silu=False))


@pytest.mark.parametrize("h,w", [(64, 64), (32, 32), (16, 16), (12, 12), (4, 4)])
def test_gnconv_core_real_zero_inside_the_image_becomes_silu_s(device, h, w):
    """x = 0 in the image's left half: those inputs become silu(s), while
    the padding around the image stays 0 (it comes after the activation)."""
    gen = torch.Generator(device).manual_seed(14)
    x = _bf16(gen, (2, 128, h, w), device)
    x[:, :, :, : w // 2] = 0
    a = 1 + 0.1 * torch.randn((2, 128), generator=gen, device=device)
    s = 1 + torch.randn((2, 128), generator=gen, device=device)
    wt = _bf16(gen, (192, 128, 3, 3), device, (9 * 128) ** -0.5)
    bias = torch.randn((192,), generator=gen, device=device)
    _close(gn_conv.gnconv3x3(x, a, s, wt, bias), gn_conv.gnconv3x3_plain(x, a, s, wt, bias),
           testing.gnconv3x3_control(x, a, s, wt, bias))


# the row windows of spatial parallelism (h rows a rank + 2 halo rows):
# SD1.5 at 512 px over sp 2 and 4 (every tile width: W 64, 32, 16 and 8),
# h = 1 and 2 (less than a tile's rows), W 12 (the fill route), B 1 and 3
ROW_WINDOW_SHAPES = [
    (2, 320, 32, 64, 320), (2, 640, 8, 32, 640), (2, 1280, 4, 16, 1280), (2, 1280, 2, 8, 1280),
    (1, 2560, 2, 8, 1280), (3, 320, 16, 64, 320), (1, 320, 1, 12, 320), (2, 640, 6, 12, 640),
]
# (top, bottom): whether the window's first and last rows are image rows
EDGES = [(True, True), (False, True), (True, False), (False, False)]


def _window(x, start, h):
    """Rows start - 1 .. start + h of the image x, zero rows past its edges."""
    return torch.nn.functional.pad(x, (0, 0, 1, 1))[:, :, start:start + h + 2].contiguous()


@pytest.mark.parametrize("b,cin,h,w,cout", ROW_WINDOW_SHAPES)
def test_conv_rows_match_plain_and_the_padded_kernel(device, b, cin, h, w, cout):
    """A window of an image of 3h rows at its middle: the row-window kernel
    against its plain version (with a control), against the padded kernel's
    rows of the whole image, and its dx through the padded kernel."""
    gen = torch.Generator(device).manual_seed(20)
    image = _bf16(gen, (b, cin, 3 * h, w), device)
    x = _window(image, h, h)
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    before = (conv.conv3x3_rows.launches, conv.conv3x3_gemm.launches)
    got = conv.conv3x3_rows(x, wt, bias)
    torch.cuda.synchronize()
    assert conv.conv3x3_rows.launches - before[0] == 1
    _close(got, conv.conv3x3_rows_plain(x, wt, bias), testing.conv3x3_rows_control(x, wt, bias))
    _close(got, conv.conv3x3_gemm(image, wt, bias)[:, :, h:2 * h].contiguous())
    assert torch.equal(conv.conv3x3_rows(x, wt, bias), got)  # the same bits
    g = _bf16(gen, (b, cout, h, w), device)
    xg = x.clone().requires_grad_()
    conv.conv3x3(xg, wt, bias, window=True).backward(g)
    torch.cuda.synchronize()
    assert conv.conv3x3_gemm.launches - before[1] == 2  # the whole image above, and the dx
    _close(xg.grad, conv.conv3x3_gemm_plain(torch.nn.functional.pad(g, (0, 0, 1, 1)),
                                            conv.flip_weight(wt)))


@pytest.mark.parametrize("top,bottom", EDGES)
@pytest.mark.parametrize("b,cin,h,w,cout", ROW_WINDOW_SHAPES)
def test_gnconv_rows_match_plain_with_each_edge(device, b, cin, h, w, cout, top, bottom):
    """The window's first (last) row is the image's padding unless `top`
    (`bottom`): the padding stays 0 after the activation, so the window's
    rows equal the padded kernel's rows of the image it is cut from."""
    gen = torch.Generator(device).manual_seed(21)
    rows = h + int(top) * h + int(bottom) * h
    image = _bf16(gen, (b, cin, rows, w), device)
    start = h if top else 0
    x = _window(image, start, h)
    a, s = _gn_affine(gen, x, device)
    s = s + 1  # silu(s) far from 0, so an unmasked padding row shows
    wt = _bf16(gen, (cout, cin, 3, 3), device, (9 * cin) ** -0.5)
    bias = torch.randn((cout,), generator=gen, device=device)
    before = gn_conv.gnconv3x3_rows.launches
    got = gn_conv.gnconv3x3_rows(x, a, s, wt, bias, True, top, bottom)
    torch.cuda.synchronize()
    assert gn_conv.gnconv3x3_rows.launches - before == 1
    _close(got, gn_conv.gnconv3x3_rows_plain(x, a, s, wt, bias, True, top, bottom),
           testing.gnconv3x3_rows_control(x, a, s, wt, bias, True, top, bottom))
    _close(got, gn_conv.gnconv3x3(image, a, s, wt, bias)[:, :, start:start + h].contiguous())
    assert torch.equal(gn_conv.gnconv3x3_rows(x, a, s, wt, bias, True, top, bottom), got)


# two ranks' rows of the GroupNorm's images at sp 2 (SD1.5 at 512 px), the
# mid block at sp 4, a ragged 3 x 5 share, the 960-channel up block
GN_SPLIT_SHAPES = [
    (2, 320, 32, 64, 1e-6, False), (2, 320, 32, 64, 1e-5, True), (2, 640, 8, 32, 1e-6, False),
    (2, 1280, 2, 8, 1e-6, False), (1, 320, 3, 5, 1e-5, True), (2, 960, 32, 64, 1e-5, True),
]


@pytest.mark.parametrize("b,c,h,w,eps,silu", GN_SPLIT_SHAPES)
def test_group_norm_split_matches_plain_and_the_one_launch_kernel(device, b, c, h, w, eps,
                                                                  silu):
    """Two ranks' rows of one image: the statistics launch on each against
    its plain version (fp32, 1e-5 of the largest sum, with a control), the
    sums added and the apply launch on each against its plain version; the
    two halves together against the one-launch kernel on the image."""
    gen = torch.Generator(device).manual_seed(22)
    image, scale, bias = _gn_inputs(gen, device, b, c, 2 * h, w)
    halves = [t.contiguous() for t in image.chunk(2, dim=2)]
    before = (gn.group_norm_stats.launches, gn.group_norm_apply.launches)
    stats = [gn.group_norm_stats(x, 32) for x in halves]
    torch.cuda.synchronize()
    for x, got in zip(halves, stats):
        ref = gn.group_norm_stats_plain(x, 32)
        limit = 1e-5 * ref.abs().max().item()
        assert (got - ref).abs().max().item() <= limit
        assert (testing.group_norm_stats_control(x, 32) - ref).abs().max().item() > limit
    sums, count = stats[0] + stats[1], c // 32 * 2 * h * w
    ys = [gn.group_norm_apply(x, scale, bias, sums, count, eps, silu) for x in halves]
    torch.cuda.synchronize()
    assert (gn.group_norm_stats.launches - before[0], gn.group_norm_apply.launches - before[1]) \
        == (2, 2)
    for x, y in zip(halves, ys):
        _close(y, gn.group_norm_apply_plain(x, scale, bias, sums, count, eps, silu),
               testing.group_norm_apply_control(x, scale, bias, sums, count, eps, silu))
    _close(torch.cat(ys, dim=2), gn.group_norm_silu(image, scale, bias, 32, eps, silu))
    assert torch.equal(gn.group_norm_stats(halves[0], 32), stats[0])  # the same bits


@pytest.mark.parametrize("cout,cin", [(320, 320), (1280, 2560), (320, 192), (24, 20)])
def test_pack_weight_kernel_equals_plain(device, cout, cin):
    gen = torch.Generator(device).manual_seed(15)
    wt = _bf16(gen, (cout, cin, 3, 3), device)
    for flip in (False, True):
        assert torch.equal(conv.pack_weight(wt, flip), conv.pack_weight_plain(wt, flip))


def test_conv_core_refuses_a_misaligned_pointer(device):
    n = 2 * 128 * 16 * 16
    x = torch.zeros(n + 1, device=device, dtype=torch.bfloat16)[1:].view(2, 128, 16, 16)
    wt = torch.zeros((128, 128, 3, 3), device=device, dtype=torch.bfloat16)
    bias = torch.zeros(128, device=device)
    with pytest.raises(ValueError):  # off the 16-byte boundary that TMA needs
        conv.conv3x3_gemm(x, wt, bias)
    a = torch.ones((2, 128), device=device)
    with pytest.raises(ValueError):
        gn_conv.gnconv3x3(x, a, a, wt, bias)


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(device):
    x = torch.zeros((1, 128, 8, 8), device=device)
    w = torch.zeros((128, 128, 3, 3), device=device)
    with pytest.raises(TypeError):
        conv.conv3x3_gemm(x, w)  # fp32 is not the kernel dtype
    with pytest.raises(ValueError):  # not contiguous
        conv.conv3x3_gemm(x.bfloat16().transpose(2, 3), w.bfloat16())
    with pytest.raises(TypeError):
        gn.group_norm_silu(x, torch.ones(128, device=device), torch.zeros(128, device=device),
                           32, 1e-5)
    with pytest.raises(ValueError):  # K = 12 is not a multiple of 8
        geglu.geglu_gemm(torch.zeros((4, 12), device=device, dtype=torch.bfloat16),
                         torch.zeros((16, 12), device=device, dtype=torch.bfloat16), None)


# the GEGLU projection (wgmma, TMA, persistent): every chip_smoke shape
# (SD1.5's three levels at B 2 and 3, and the target's rank-4 LoRA), a ragged
# M (1, 100, 8191), K not a multiple of 64 (40, 72, 328), N not a multiple
# of the 64- or 128-wide tile (8, 24, 1288), every LoRA rank 1-16, and
# SD1.5's mid block (M 128 at batch 2, where the 64-wide tile is taken)
GEGLU_CORE_SHAPES = [
    (8192, 320, 1280, 0), (2048, 640, 2560, 0), (512, 1280, 5120, 0), (12288, 320, 1280, 0),
    (4096, 320, 1280, 4), (1024, 640, 2560, 4), (256, 1280, 5120, 4), (8192, 320, 1280, 4),
    (1, 320, 1280, 0), (100, 320, 1280, 4), (8191, 320, 1280, 1), (100, 40, 24, 3),
    (512, 72, 640, 0), (1000, 328, 1280, 16), (256, 320, 8, 4), (300, 320, 1288, 0),
    (128, 1280, 5120, 0), (128, 1280, 5120, 4), (64, 640, 2560, 16),
    # SDXL at 1024 px: levels 1 and 2 at the inner loop's 2B (K 640 and
    # 1280, N 2 x 2560 and 2 x 5120) and the target's rank-4 LoRA at B
    (8192, 640, 2560, 0), (2048, 1280, 5120, 0), (4096, 640, 2560, 4), (1024, 1280, 5120, 4),
]


def _geglu_inputs(gen, device, m, k, n, r, with_bias=True):
    x = _bf16(gen, (m, k), device)
    wt = _bf16(gen, (2 * n, k), device, k**-0.5)
    bias = torch.randn((2 * n,), generator=gen, device=device) if with_bias else None
    xd = _bf16(gen, (m, r), device) if r else None
    up = _bf16(gen, (2 * n, r), device, 0.5) if r else None
    return x, wt, bias, xd, up


@pytest.mark.parametrize("m,k,n,r", GEGLU_CORE_SHAPES)
def test_geglu_matches_plain(device, m, k, n, r):
    gen = torch.Generator(device).manual_seed(5)
    args = _geglu_inputs(gen, device, m, k, n, r)
    before = geglu.geglu_gemm.launches
    got = geglu.geglu_gemm(*args)
    torch.cuda.synchronize()
    assert geglu.geglu_gemm.launches - before == 1
    control = testing.geglu_control(*args) if k > testing.CONTROL_DROPPED else None
    _close(got, geglu.geglu_gemm_plain(*args), control)
    assert torch.equal(geglu.geglu_gemm(*args), got)  # two calls, the same bits


@pytest.mark.parametrize("m,k,n,r", [(8192, 320, 1280, 0), (100, 72, 8, 4),
                                     (128, 1280, 5120, 16)])
def test_geglu_core_without_bias(device, m, k, n, r):
    gen = torch.Generator(device).manual_seed(17)
    args = _geglu_inputs(gen, device, m, k, n, r, with_bias=False)
    _close(geglu.geglu_gemm(*args), geglu.geglu_gemm_plain(*args))


def test_geglu_refuses_a_misaligned_pointer(device):
    x = torch.zeros(64 * 320 + 1, device=device, dtype=torch.bfloat16)[1:].view(64, 320)
    wt = torch.zeros((2 * 1280, 320), device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # off the 16-byte boundary that TMA needs
        geglu.geglu_gemm(x, wt, None)
    with pytest.raises(ValueError):
        geglu.geglu_gemm(wt[:64].contiguous(), torch.zeros(
            2 * 1280 * 320 + 1, device=device, dtype=torch.bfloat16)[1:].view(2 * 1280, 320), None)


# the GroupNorm (a cluster per (batch, group), one read): every chip_smoke
# shape, n % 8 != 0 (3 x 5 and 5 x 7 images: groups start off 16-byte
# boundaries), the largest group kept on chip (2, 960, 64^2: n 122,880), a
# group that takes the re-reading route (1, 2560, 64^2: n 327,680), C = 32
# (one channel a group), B = 1 with SiLU on and off
GN_CORE_SHAPES = [
    (1, 2560, 16, 16, 1e-5, True), (3, 1280, 8, 8, 1e-6, False), (1, 320, 5, 7, 1e-5, True),
    (2, 320, 64, 64, 1e-6, False), (2, 640, 32, 32, 1e-6, False),
    (2, 1280, 16, 16, 1e-6, False), (2, 1280, 8, 8, 1e-6, False),
    (2, 320, 64, 64, 1e-5, True), (3, 320, 64, 64, 1e-6, False),
    (1, 320, 64, 64, 1e-6, False),
    (2, 320, 3, 5, 1e-5, False), (2, 320, 3, 5, 1e-5, True),
    (2, 960, 64, 64, 1e-5, True), (1, 2560, 64, 64, 1e-6, False),
    (2, 32, 16, 16, 1e-6, True), (1, 32, 7, 9, 1e-6, False),
    (1, 640, 32, 32, 1e-6, True), (1, 640, 32, 32, 1e-6, False),
    # SDXL at 1024 px: conv_norm_out (groups of 10 x 128^2 = 163,840, the
    # re-reading route) and the level-1 and level-2 transformer norms
    (2, 320, 128, 128, 1e-5, True), (2, 640, 64, 64, 1e-6, False),
    (2, 1280, 32, 32, 1e-6, False),
]


def _gn_inputs(gen, device, b, c, h, w):
    x = (torch.randn((b, c, h, w), generator=gen, device=device) * 3 + 1).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn((c,), generator=gen, device=device)
    bias = 0.1 * torch.randn((c,), generator=gen, device=device)
    return x, scale, bias


@pytest.mark.parametrize("b,c,h,w,eps,silu", GN_CORE_SHAPES)
def test_group_norm_matches_plain(device, b, c, h, w, eps, silu):
    gen = torch.Generator(device).manual_seed(4)
    x, scale, bias = _gn_inputs(gen, device, b, c, h, w)
    before = gn.group_norm_silu.launches
    got = gn.group_norm_silu(x, scale, bias, 32, eps, silu)
    torch.cuda.synchronize()
    assert gn.group_norm_silu.launches - before == 1
    _close(got, gn.group_norm_silu_plain(x, scale, bias, 32, eps, silu),
           testing.group_norm_control(x, scale, bias, 32, eps, silu))
    assert torch.equal(gn.group_norm_silu(x, scale, bias, 32, eps, silu), got)  # the same bits


@pytest.mark.parametrize("b,c,h,w", [(2, 320, 64, 64), (2, 320, 3, 5)])
def test_group_norm_core_takes_a_misaligned_input(device, b, c, h, w):
    """x off a 16-byte boundary (and so off y's alignment): every element
    goes one at a time, with the same result."""
    gen = torch.Generator(device).manual_seed(19)
    x, scale, bias = _gn_inputs(gen, device, b, c, h, w)
    shifted = torch.empty(x.numel() + 1, device=device, dtype=torch.bfloat16)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    got = gn.group_norm_silu(shifted, scale, bias, 32, 1e-6, True)
    _close(got, gn.group_norm_silu_plain(x, scale, bias, 32, 1e-6, True),
           testing.group_norm_control(x, scale, bias, 32, 1e-6, True))
