"""GEGLU: the exact gelu with a polynomial erf, the plain and split forms of
the projection, and the fused Hopper kernel with its autograd Function.

Counterpart of `leco_tpu/ops/geglu.py`. The transformer feed-forward's first
half is `proj = x W^T + b (+ LoRA); value, gate = split(proj);
out = value * gelu(gate)`. The TPU kernel `_kernel` becomes
`leco_tpu_torch/kernels/csrc/geglu.cu`, a persistent wgmma + TMA kernel:
both GEMM halves, the rank-r LoRA delta and the gelu·mul epilogue on the SM,
writing only (M, N).

Layouts are the port's (torch Linear): weight (2N, K), bias (2N), the LoRA
delta's xd = (x down^T) * scale (..., r) and up (2N, r). The JAX package
takes the transposes, kernel (K, 2N) and up (r, 2N).

Backends (`LECO_GEGLU`, read at call time, the JAX package's values):
"xla" (default) `geglu_reference`, "split" `geglu_split`, "fused"
`geglu_fused`. On CUDA the kernel takes bf16; an fp32 CUDA tensor takes
`geglu_reference` (see `supports`). On the CPU the kernel's wrapper runs its
plain version, `geglu_gemm_plain`.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from leco_tpu_torch.kernels import launch

_INV_SQRT2 = 2.0**-0.5
MAX_RANK = 16  # the kernel pads the LoRA rank to one MMA depth


def default_geglu_backend() -> str:
    return os.environ.get("LECO_GEGLU", "xla")


def supports(dtype: torch.dtype, device: torch.device) -> bool:
    """May `geglu_fused` take this input? On CUDA the kernel is bf16 only;
    on the CPU every dtype runs the kernel's plain version."""
    return torch.device(device).type != "cuda" or dtype == torch.bfloat16


def _erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), as the JAX
    package computes it (geglu.py:69-84)."""
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    p = 0.3275911
    s = torch.sign(x)
    ax = x.abs()
    t = 1.0 / (1.0 + p * ax)
    poly = ((((a5 * t + a4) * t + a3) * t + a2) * t + a1) * t
    return s * (1.0 - poly * torch.exp(-ax * ax))


def _gelu_exact_f32(g: torch.Tensor, erf=torch.erf) -> torch.Tensor:
    return 0.5 * g * (1.0 + erf(g * _INV_SQRT2))


def gelu_exact(g: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu with the erf from the A&S polynomial, in fp32,
    rounded to g's dtype. `LECO_GELU=erf` takes torch's erf gelu instead."""
    if os.environ.get("LECO_GELU") == "erf":
        return F.gelu(g)
    gf = g.float()
    return _gelu_exact_f32(gf, erf=_erf_poly).to(g.dtype)


def geglu_reference(x, weight, bias, xd=None, up=None):
    """The single-GEMM form (the JAX package's default and the tests'
    ground truth): everything in x's dtype."""
    dt = x.dtype
    proj = F.linear(x, weight.to(dt), None if bias is None else bias.to(dt))
    if xd is not None:
        proj = proj + F.linear(xd.to(dt), up.to(dt))
    value, gate = proj.chunk(2, dim=-1)
    return value * gelu_exact(gate)


def geglu_split(x, weight, bias, xd=None, up=None):
    """Two half GEMMs, value = x W[:n]^T and gate = x W[n:]^T; the same
    columns and reductions as the single-GEMM form."""
    dt = x.dtype
    n = weight.shape[0] // 2
    value = F.linear(x, weight[:n].to(dt))
    gate = F.linear(x, weight[n:].to(dt))
    if bias is not None:
        value = value + bias[:n].to(dt)
        gate = gate + bias[n:].to(dt)
    if xd is not None:
        value = value + F.linear(xd.to(dt), up[:n].to(dt))
        gate = gate + F.linear(xd.to(dt), up[n:].to(dt))
    return value * gelu_exact(gate)


# ---------------------------------------------------------------------------
# the kernel: plain version and wrapper, on 2-D x
# ---------------------------------------------------------------------------


def geglu_gemm_plain(x2, weight, bias, xd=None, up=None):
    """The TPU kernel `_kernel` (geglu.py:91-102): operands in x's dtype,
    fp32 products and fp32 bias, value * gelu(gate) with the polynomial erf
    in fp32, one rounding. x2 (M, K) -> (M, N)."""
    dt = x2.dtype
    n = weight.shape[0] // 2
    w = weight.to(dt).float()
    proj = x2.float() @ w.T
    if xd is not None:
        proj = proj + xd.to(dt).float() @ up.to(dt).float().T
    if bias is not None:
        proj = proj + bias.float()
    v, g = proj[:, :n], proj[:, n:]
    return (v * _gelu_exact_f32(g, erf=_erf_poly)).to(dt)


def geglu_gemm(x2, weight, bias, xd=None, up=None):
    """Fused GEGLU projection -> (M, N). Kernel: csrc/geglu.cu. weight, xd
    and up must already be in x's dtype (bf16) on CUDA; the bias may be any
    float dtype and goes to the kernel in fp32."""
    if not x2.is_cuda:
        return geglu_gemm_plain(x2, weight, bias, xd, up)
    name = "geglu_gemm"
    if x2.dtype != torch.bfloat16:
        raise TypeError(f"{name}: dtype {x2.dtype} is not the kernel's bfloat16")
    m, k = x2.shape
    n2 = weight.shape[0]
    n = n2 // 2
    r = 0 if xd is None else xd.shape[-1]
    if k % 8 or n % 8 or n2 != 2 * n:
        raise ValueError(f"{name}: K = {k} and N = {n} must be multiples of 8")
    if r > MAX_RANK:
        raise ValueError(f"{name}: LoRA rank {r} > {MAX_RANK}")
    dev = x2.device
    # x and W are read by TMA, whose tensor maps need 16-byte starts
    launch.check(name, "x", x2, torch.bfloat16, (m, k), dev, aligned=True)
    launch.check(name, "weight", weight, torch.bfloat16, (n2, k), dev, aligned=True)
    if bias is not None:
        bias = bias.float().contiguous()
        launch.check(name, "bias", bias, torch.float32, (n2,), dev)
    if xd is not None:
        launch.check(name, "xd", xd, torch.bfloat16, (m, r), dev)
        launch.check(name, "up", up, torch.bfloat16, (n2, r), dev)
    from leco_tpu_torch.kernels.build import library

    def ptr(t):
        return None if t is None else t.data_ptr()

    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = library().leco_geglu(
        x2.data_ptr(), weight.data_ptr(), ptr(bias), ptr(xd), ptr(up),
        out.data_ptr(), m, k, n, r, launch.stream(x2),
    )
    launch.raise_on(name, err)
    geglu_gemm.launches += 1
    return out


KERNEL_WRAPPERS = (geglu_gemm,)
launch.reset(KERNEL_WRAPPERS)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class GegluFused(torch.autograd.Function):
    """Forward: the kernel. Backward: the analytic fp32 recompute of the JAX
    package's `_geglu_bwd` (geglu.py:229-266), exact erf in the derivative,
    for the inputs that need a gradient only."""

    @staticmethod
    def forward(ctx, x, weight, bias, xd, up):
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k).contiguous()
        xd2 = None if xd is None else xd.reshape(-1, xd.shape[-1]).contiguous()
        out = geglu_gemm(x2, weight.contiguous(), bias, xd2,
                         None if up is None else up.contiguous())
        ctx.save_for_backward(x, weight, bias, xd, up)
        return out.reshape(*lead, -1)

    @staticmethod
    def backward(ctx, gout):
        x, weight, bias, xd, up = ctx.saved_tensors
        need_x, need_w, need_b, need_xd, need_up = ctx.needs_input_grad
        xk = x.float()
        w = weight.float()
        proj = xk @ w.T
        if bias is not None:
            proj = proj + bias.float()
        if xd is not None:
            proj = proj + xd.float() @ up.float().T
        n = proj.shape[-1] // 2
        v, g = proj[..., :n], proj[..., n:]
        gg = gout.float()
        dv = gg * _gelu_exact_f32(g)
        pdf = torch.exp(-0.5 * g * g) * (1.0 / math.sqrt(2.0 * math.pi))
        dact = 0.5 * (1.0 + torch.erf(g * _INV_SQRT2)) + g * pdf
        dproj = torch.cat([dv, gg * v * dact], dim=-1)
        flat = dproj.reshape(-1, dproj.shape[-1])
        dx = (dproj @ w).to(x.dtype) if need_x else None
        dw = (flat.T @ xk.reshape(-1, xk.shape[-1])).to(weight.dtype) if need_w else None
        db = flat.sum(0).to(bias.dtype) if need_b else None
        dxd = (dproj @ up.float()).to(xd.dtype) if need_xd else None
        dup = (flat.T @ xd.float().reshape(-1, xd.shape[-1])).to(up.dtype) if need_up else None
        return dx, dw, db, dxd, dup


def geglu_fused(x, weight, bias, xd=None, up=None):
    """value * gelu_exact(gate) of proj = x W^T + bias + xd up^T on the
    kernel; xd and up may be None (no LoRA)."""
    return GegluFused.apply(x, weight, bias, xd, up)
