"""The port's GEGLU (leco_tpu_torch/ops/geglu.py) against the JAX package's.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_geglu.py does; the port's side runs the kernel's plain version
(what the wrapper takes for a CPU tensor). Inputs come from a numpy seed;
the port takes the torch Linear layout, weight (2N, K) and up (2N, r), the
JAX package their transposes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from leco_tpu.ops import geglu as jgeglu
from leco_tpu_torch import lora
from leco_tpu_torch.ops import geglu

# fp32: the two sides differ by summation order only; bf16: one rounding of
# the output at bf16 resolution (the products are fp32 on both sides)
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mats(seed=0, m=256, k=128, n2=256, r=4):
    """x (M, K), weight (2N, K), bias (2N), xd (M, r), up (2N, r)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(m, k), 0.1 * f(n2, k), f(n2), f(m, r), 0.1 * f(n2, r)


def _to_jax(x, w, b, xd, up, jdt=jnp.float32):
    """Port layout -> the JAX package's (kernel (K, 2N), up (r, 2N))."""
    cast = lambda a: None if a is None else jnp.asarray(a).astype(jdt)  # noqa: E731
    return cast(x), cast(w.T), jnp.asarray(b), cast(xd), None if up is None else cast(up.T)


def _to_torch(x, w, b, xd, up, tdt=torch.float32):
    cast = lambda a: None if a is None else torch.from_numpy(a).to(tdt)  # noqa: E731
    return cast(x), cast(w), torch.from_numpy(b), cast(xd), cast(up)


def test_gelu_exact_matches_jax_polynomial(monkeypatch):
    """Independent of what earlier tests in the process left behind: both
    functions read LECO_GELU at call time, so it is unset here, and the JAX
    side is one program compiled for this test with XLA's fast math pinned
    off (as JAX runs the gelu, inside a jitted program), not the eager
    per-operation executables that every test in the process shares."""
    monkeypatch.delenv("LECO_GELU", raising=False)
    g = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    got = geglu.gelu_exact(torch.from_numpy(g)).numpy()
    jg = jnp.asarray(g)
    jax_gelu = jax.jit(jgeglu.gelu_exact).lower(jg).compile(
        compiler_options={"xla_cpu_enable_fast_math": False})
    want = np.asarray(jax_gelu(jg))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_gelu_erf_knob_takes_the_exact_gelu(monkeypatch):
    monkeypatch.setenv("LECO_GELU", "erf")
    g = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    got = geglu.gelu_exact(torch.from_numpy(g)).numpy()
    # held to the gelu itself, in float64: the fp32 erf's evaluation error
    # only (torch's and XLA's fp32 erf gelus differ from each other by up to
    # 7.4e-7 on this grid, so neither is the other's reference)
    exact = torch.nn.functional.gelu(torch.from_numpy(g).double()).numpy()
    np.testing.assert_allclose(got, exact, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("with_lora", [False, True])
def test_kernel_plain_matches_jax_kernel(with_lora, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, xd, up = _mats()
    if not with_lora:
        xd = up = None
    with pltpu.force_tpu_interpret_mode():
        want = jgeglu.geglu_fused(*_to_jax(x, w, b, xd, up, jdt))
    got = geglu.geglu_gemm_plain(*_to_torch(x, w, b, xd, up, tdt))
    assert got.dtype == tdt and got.shape == (256, 128)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=ATOL[dtype] if dtype == "bfloat16" else 0)


@pytest.mark.parametrize("form", ["reference", "split"])
@pytest.mark.parametrize("with_lora", [False, True])
def test_plain_forms_match_jax(form, with_lora):
    x, w, b, xd, up = _mats(seed=1, m=64, k=32, n2=64)
    if not with_lora:
        xd = up = None
    want = getattr(jgeglu, f"geglu_{form}")(*_to_jax(x, w, b, xd, up))
    got = getattr(geglu, f"geglu_{form}")(*_to_torch(x, w, b, xd, up))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gradients_match_jax_custom_vjp():
    """The autograd Function (kernel forward, analytic recompute backward)
    against jax.grad through the JAX package's custom VJP, fp32, for every
    input, on a 3-D x as the transformer passes it."""
    x, w, b, xd, up = _mats(seed=2)
    x3, xd3 = x.reshape(2, 128, 128), xd.reshape(2, 128, 4)

    def loss(x, w, b, xd, up):
        return jnp.sum(jgeglu.geglu_fused(x, w, b, xd, up) ** 2)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*_to_jax(x3, w, b, xd3, up))
    ts = [t.requires_grad_() for t in _to_torch(x3, w, b, xd3, up)]
    (geglu.geglu_fused(*ts) ** 2).sum().backward()
    got = [t.grad.numpy() for t in ts]
    got[1], got[4] = got[1].T, got[4].T  # to the JAX layout
    for g, wnt in zip(got, want):
        scale = float(np.abs(wnt).max())
        np.testing.assert_allclose(g, np.asarray(wnt), atol=1e-5 * scale)


def test_backward_computes_only_what_is_asked():
    x, w, b, xd, up = _to_torch(*_mats(seed=3, m=32, k=16, n2=32))
    x.requires_grad_()
    out = geglu.geglu_fused(x, w, b, xd, up)
    out.sum().backward()
    assert x.grad is not None and w.grad is None and up.grad is None


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    geglu.geglu_gemm.launches = 0
    args = _to_torch(*_mats(seed=4, m=32, k=16, n2=32))
    assert torch.equal(geglu.geglu_gemm(*args), geglu.geglu_gemm_plain(*args))
    assert geglu.geglu_gemm.launches == 0


@pytest.mark.parametrize(
    "dtype,device,want",
    [(torch.bfloat16, "cuda", True), (torch.float32, "cuda", False),
     (torch.float32, "cpu", True), (torch.bfloat16, "cpu", True)],
)
def test_dispatch_rule(dtype, device, want):
    assert geglu.supports(dtype, torch.device(device)) is want


@pytest.mark.parametrize("backend,called", [(None, "geglu_reference"),
                                            ("xla", "geglu_reference"),
                                            ("split", "geglu_split"),
                                            ("fused", "geglu_fused")])
@pytest.mark.parametrize("mode", ["on", "off", "folded"])
def test_lora_linear_routes_the_geglu_projection(backend, called, mode, monkeypatch):
    """`LoRALinear.geglu`: the backend `LECO_GEGLU` names; the LoRA delta xd
    goes in only in the "on" mode, the folded weight in the "folded" mode;
    the result equals the layer's own projection followed by value *
    gelu_exact(gate)."""
    if backend is None:
        monkeypatch.delenv("LECO_GEGLU", raising=False)
    else:
        monkeypatch.setenv("LECO_GEGLU", backend)
    rng = np.random.default_rng(5)
    layer = lora.LoRALinear(16, 64)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)))
        layer.bias.copy_(torch.from_numpy(rng.standard_normal(64).astype(np.float32)))
    layer.add_lora(lora.LoRASpec(rank=4, alpha=1.0), torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.lora_up.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    seen = []
    real = getattr(geglu, called)
    monkeypatch.setattr(geglu, called, lambda *a: seen.append(a[3] is not None) or real(*a))
    if mode == "folded":
        layer.fold()
    layer.mode = mode
    with torch.no_grad():
        got = layer.geglu(x)
        value, gate = layer(x).chunk(2, dim=-1)
    assert seen == [mode == "on"]
    np.testing.assert_allclose(got.numpy(), (value * geglu.gelu_exact(gate)).numpy(),
                               atol=1e-5)
