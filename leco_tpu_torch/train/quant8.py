"""Blockwise dynamic 8-bit optimizer states (Adam8bit / Lion8bit).

Counterpart of `leco_tpu/train/quant8.py`, which the port holds itself to
(not to bitsandbytes, which that module is not bit-identical to either,
QUIRKS #16). Each moment leaf is stored flattened in blocks of `block_size`
values as uint8 codes plus one fp32 absmax per block; a code indexes a
256-entry dynamic-tree codebook (7 exponent levels 10^-6 .. 10^0, linear
fractions in [0.1, 1) per level, twice as many for the unsigned second
moment, plus exact 0 and 1), and quantization picks the nearest codeword of
value / absmax by a search over the codeword midpoints. Every step
dequantizes, runs the fp32 Adam or Lion math of the JAX module, and
requantizes: the states never exist in fp32 between steps, and
`state_dict()` holds them as uint8 and fp32. The optimizers lay every leaf
out in whole blocks of one flat buffer, so a step is a few kernels over
the whole tree rather than a few per leaf; a block never spans two leaves,
so the codes are the JAX module's per-leaf codes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from leco_tpu_torch.train.optim import TreeOptimizer, bias_correction

BLOCK_SIZE = 2048


def dynamic_codebook(signed: bool = True) -> np.ndarray:
    """256-entry dynamic-tree codebook in [-1, 1] (signed) or [0, 1]."""
    values = [0.0, 1.0]
    levels = 7
    for i in range(levels):
        n = 2**i if signed else 2 ** (i + 1)
        bounds = np.linspace(0.1, 1.0, n + 1)
        means = (bounds[:-1] + bounds[1:]) / 2.0
        scaled = means * 10.0 ** (i - (levels - 1))
        values.extend(scaled.tolist())
        if signed:
            values.extend((-scaled).tolist())
    out = np.sort(np.asarray(values, np.float32))
    if out.shape != (256,):
        raise AssertionError(out.shape)
    return out


CODE = {True: dynamic_codebook(signed=True), False: dynamic_codebook(signed=False)}
# nearest codeword by a search over the decision boundaries (float32)
MIDPOINTS = {s: (book[1:] + book[:-1]) / np.float32(2.0) for s, book in CODE.items()}


def quantize_blockwise(x: torch.Tensor, signed: bool = True, block_size: int = BLOCK_SIZE,
                       midpoints: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (codes uint8 (nblocks, block_size), absmax fp32 (nblocks, 1)); the
    last block is zero-padded. `midpoints`: MIDPOINTS[signed] already on
    x's device."""
    flat = x.float().reshape(-1)
    pad = -flat.numel() % block_size
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, block_size)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    normed = blocks / torch.clamp_min(absmax, 1e-30)
    if midpoints is None:
        midpoints = torch.from_numpy(MIDPOINTS[signed]).to(x.device)
    codes = torch.searchsorted(midpoints, normed).to(torch.uint8)
    return codes, absmax


def dequantize_blockwise(codes: torch.Tensor, absmax: torch.Tensor, shape,
                         signed: bool = True, book: torch.Tensor | None = None) -> torch.Tensor:
    """`book`: CODE[signed] already on the codes' device."""
    if book is None:
        book = torch.from_numpy(CODE[signed]).to(codes.device)
    vals = book[codes.long()] * absmax
    return vals.reshape(-1)[: int(np.prod(shape))].reshape(shape)


class _Quantized(TreeOptimizer):
    """The moments named in `MOMENTS` ((name, signed) pairs), each kept as
    `<name>_codes` (uint8) and `<name>_absmax` (fp32) over a flat buffer in
    which leaf i owns the whole blocks from offset i on."""

    MOMENTS: tuple = ()

    def __init__(self, params, lr: float, **hyper):
        super().__init__(params, lr, **hyper)
        self._tables: dict = {}

    def layout(self, params) -> tuple[list[int], int]:
        """Each leaf's offset in the flat buffer, and the buffer's size."""
        bs = self.param_groups[0]["block_size"]
        offsets, total = [], 0
        for p in params:
            offsets.append(total)
            total += -(-p.numel() // bs) * bs
        return offsets, total

    def tables(self, signed: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(codebook, midpoints) on `device`, copied there once."""
        key = (signed, str(device))
        if key not in self._tables:
            self._tables[key] = (torch.from_numpy(CODE[signed]).to(device),
                                 torch.from_numpy(MIDPOINTS[signed]).to(device))
        return self._tables[key]

    def flat(self, tensors: list, params: list) -> torch.Tensor:
        """A zero buffer holding `tensors` (fp32) in the leaves' slots."""
        offsets, total = self.layout(params)
        buf = torch.zeros(total, dtype=torch.float32, device=params[0].device)
        torch._foreach_copy_([buf[o:o + p.numel()].view(p.shape) for o, p in zip(offsets, params)],
                             [t.float() for t in tensors])
        return buf

    def init_state(self, params):
        _, total = self.layout(params)
        zeros = torch.zeros(total, dtype=torch.float32, device=params[0].device)
        for name, signed in self.MOMENTS:
            self.save_moment(name, zeros, signed)

    def moment(self, name: str, signed: bool) -> torch.Tensor:
        st = self.shared
        book, _ = self.tables(signed, st[f"{name}_codes"].device)
        return dequantize_blockwise(st[f"{name}_codes"], st[f"{name}_absmax"],
                                    (st[f"{name}_codes"].numel(),), signed, book)

    def save_moment(self, name: str, value: torch.Tensor, signed: bool) -> None:
        _, mids = self.tables(signed, value.device)
        self.shared[f"{name}_codes"], self.shared[f"{name}_absmax"] = quantize_blockwise(
            value, signed, self.param_groups[0]["block_size"], mids)

    def apply(self, group: dict, out: torch.Tensor, params: list) -> None:
        """p -= lr * (out + wd * p) per leaf, `out` the flat update."""
        offsets, _ = self.layout(params)
        outs = [out[o:o + p.numel()].view(p.shape) for o, p in zip(offsets, params)]
        if group["weight_decay"]:
            outs = torch._foreach_add(outs, torch._foreach_mul(params, group["weight_decay"]))
        torch._foreach_add_(params, torch._foreach_mul(outs, -group["lr"]))

    def state_bytes(self) -> int:
        """Bytes of the quantized moments (codes and absmax)."""
        return sum(t.numel() * t.element_size() for key, t in self.shared.items()
                   if key.endswith(("_codes", "_absmax")))

    def load_state_dict(self, state_dict: dict) -> None:
        # torch casts floating-point params' state to their dtype: the codes
        # go back to uint8 (their values are small integers, exact in fp32)
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for key in [k for k in st if k.endswith("_codes")]:
                st[key] = st[key].to(torch.uint8)


class Adam8bit(_Quantized):
    """`quant8.adam8bit`: Adam with 8-bit moments (torch Adam defaults),
    optional decoupled weight decay, then -lr."""

    MOMENTS = (("mu", True), ("nu", False))

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, block_size: int = BLOCK_SIZE):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                         block_size=block_size)

    def update(self, group, params, grads, count):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = self.flat(grads, params)
        m = self.moment("mu", True) * b1 + g * (1.0 - b1)
        v = self.moment("nu", False) * b2 + g * (1.0 - b2) * g
        out = (m / bias_correction(b1, count)) / (
            torch.sqrt(v / bias_correction(b2, count)) + eps)
        self.save_moment("mu", m, True)
        self.save_moment("nu", v, False)
        self.apply(group, out, params)


class Lion8bit(_Quantized):
    """`quant8.lion8bit`: Lion with an 8-bit momentum, optional decoupled
    weight decay, then -lr."""

    MOMENTS = (("mu", True),)

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 0.0, block_size: int = BLOCK_SIZE):
        super().__init__(params, lr, b1=b1, b2=b2, weight_decay=weight_decay,
                         block_size=block_size)

    def update(self, group, params, grads, count):
        b1, b2 = group["b1"], group["b2"]
        g = self.flat(grads, params)
        m = self.moment("mu", True)
        u = torch.sign(m * b1 + g * (1.0 - b1))
        self.save_moment("mu", m * b2 + g * (1.0 - b2), True)
        self.apply(group, u, params)
