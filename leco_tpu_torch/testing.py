"""Test/bench fixtures: randomly initialized model bundles and checkpoints.

Counterpart of `leco_tpu/testing.py`: a tiny UNet with a fake text encoder
that runs the whole train loop on the CPU in seconds, and a full-width
SD1.5 bundle with random weights for the card (training speed does not
depend on the weight values). Every draw comes from one seeded
`torch.Generator`; the fake encoder is seeded by the prompt's sha256 through
numpy.

The checkpoint writers put random weights on disk in the layouts the
loader reads, for the CLI: `write_single_file_checkpoint` an SD2-style LDM
`.safetensors` (the UNet through the inverse of the port's UNet remap, the
OpenCLIP tower through the inverse of `ldm_openclip_to_hf`) with a
`tokenizer/` beside it, and `write_diffusers_checkpoint` a diffusers
directory. For inference and eval, `write_vae_dir` writes a diffusers
`vae/` (the decoder half of AutoencoderKL, SD's widths by default) and
`write_clip_dir` a CLIP dual-encoder directory (`config.json` with
`text_config`, `vision_config` and `projection_dim`, one `model.safetensors`,
a synthetic tokenizer; ViT-L/14 with its 12-layer text tower by default).
For SDXL, `write_sdxl_single_file` writes an SDXL LDM single file (the
UNet with `label_emb`, CLIP-L under `conditioner.embedders.0.transformer.`,
bigG under `conditioner.embedders.1.model.`) with `tokenizer/` and
`tokenizer_2/` beside it, generating and writing one tensor at a time (full
width is 6.8 GB in fp16), and `write_sdxl_diffusers_checkpoint` the
diffusers layout. Both packages' loaders read these files. The tokenizer is synthetic: the byte-level base vocabulary of
CLIP's BPE (512 entries), merges that make each given word one token, and
`<|startoftext|>` 49406 and `<|endoftext|>` 49407, so every id is below
49408 and any text tokenizes.

The controls (`*_control`) are what a fused kernel with a typical fault
would compute, built from its plain version: each must fail the error limit
that its kernel is held to (chip_smoke and the card tests check that it
does), so that the limit is shown to catch such a fault.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from leco_tpu_torch.lora import (
    LoRAConv2d,
    LoRALinear,
    LoRASpec,
    apply_lora_spec,
    write_safetensors,
)
from leco_tpu_torch.models import convert
from leco_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    sd1_text_config,
    sd2_text_config,
    sdxl_text2_config,
)
from leco_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from leco_tpu_torch.models.tokenizer import SPECIAL_TOKENS, _bytes_to_unicode
from leco_tpu_torch.models.unet import (
    UNet2DConditionModel,
    UNetConfig,
    sd15_config,
    sd21_config,
    sdxl_config,
    tiny_unet_config,
)
from leco_tpu_torch.models.vae import VAEDecoder, VAEDecoderConfig
from leco_tpu_torch.ops import conv, geglu, gn_conv
from leco_tpu_torch.ops import group_norm as gn
from leco_tpu_torch.ops.attention import default_backend
from leco_tpu_torch.ops.schedulers import NoiseScheduler
from leco_tpu_torch.prompts import PromptEmbedsXL
from leco_tpu_torch.train.trainer import ModelBundle


CONTROL_DROPPED = 64  # input channels (conv) or K columns (GEGLU) a control leaves out


def conv3x3_control(x, weight, bias=None):
    """The plain conv without its last 64 input channels."""
    k = x.shape[1] - CONTROL_DROPPED
    return conv.conv3x3_gemm_plain(x[:, :k].contiguous(), weight[:, :k], bias)


def gnconv3x3_control(x, a, s, weight, bias, with_silu: bool = True):
    """The plain GroupNorm-SiLU-conv with the zero padding put before the
    activation (the border taps see silu(s), not 0)."""
    y = gn_conv.apply_affine_silu(torch.nn.functional.pad(x, (1, 1, 1, 1)), a, s, with_silu)
    out = torch.nn.functional.conv2d(y.float(), weight.to(x.dtype).float(), None, 1, 0)
    return (out + bias.float()[None, :, None, None]).to(x.dtype)


def group_norm_control(x, scale, bias, num_groups: int, eps: float, with_silu: bool = True):
    """The plain GroupNorm with its last group's channels left as the input,
    unnormalised (a reduction that misses a group)."""
    y = gn.group_norm_silu_plain(x, scale, bias, num_groups, eps, with_silu)
    cg = x.shape[1] // num_groups
    y[:, -cg:] = x[:, -cg:]
    return y


def conv3x3_rows_control(x, weight, bias=None):
    """The plain row-window conv without its last 64 input channels."""
    k = x.shape[1] - CONTROL_DROPPED
    return conv.conv3x3_rows_plain(x[:, :k].contiguous(), weight[:, :k], bias)


def gnconv3x3_rows_control(x, a, s, weight, bias, with_silu: bool = True,
                           top: bool = True, bottom: bool = True):
    """The plain row-window GroupNorm-SiLU-conv with its padding rows taken
    for image rows (silu(s) where the padding is 0); for a window with no
    padding row, without its last 64 input channels."""
    if not (top and bottom):
        return gn_conv.gnconv3x3_rows_plain(x, a, s, weight, bias, with_silu, True, True)
    k = x.shape[1] - CONTROL_DROPPED
    return gn_conv.gnconv3x3_rows_plain(x[:, :k].contiguous(), a[:, :k], s[:, :k],
                                        weight[:, :k], bias, with_silu, top, bottom)


def group_norm_stats_control(x, num_groups: int):
    """The plain statistics without x's last image row (a reduction that
    misses a tile)."""
    return gn.group_norm_stats_plain(x[:, :, :-1], num_groups)


def group_norm_apply_control(x, scale, bias, sums, count: int, eps: float,
                             with_silu: bool = True):
    """The plain normalisation with the last group's channels left as the
    input, unnormalised."""
    y = gn.group_norm_apply_plain(x, scale, bias, sums, count, eps, with_silu)
    cg = x.shape[1] // sums.shape[1]
    y[:, -cg:] = x[:, -cg:]
    return y


def geglu_control(x, weight, bias, xd=None, up=None):
    """The plain GEGLU without the last 64 columns of K."""
    k = x.shape[1] - CONTROL_DROPPED
    return geglu.geglu_gemm_plain(x[:, :k], weight[:, :k], bias, xd, up)


def fake_encode_fn(cross_attention_dim: int, device, pooled_dim: Optional[int] = None):
    """Deterministic pseudo-embedding per prompt string: the ESD objective
    only needs distinct, consistent embeddings. With `pooled_dim` (SDXL) a
    PromptEmbedsXL, its pooled embedding drawn after the sequence."""

    def encode(prompt: str):
        digest = hashlib.sha256(prompt.encode()).digest()
        rng = np.random.default_rng(int.from_bytes(digest[:4], "little"))
        seq = torch.from_numpy(
            rng.standard_normal((1, 77, cross_attention_dim), dtype=np.float32)).to(device)
        if pooled_dim is None:
            return seq
        pooled = rng.standard_normal((1, pooled_dim), dtype=np.float32)
        return PromptEmbedsXL(seq, torch.from_numpy(pooled).to(device))

    return encode


def xl_pooled_dim(config: UNetConfig) -> int:
    """The pooled embedding's width an SDXL UNet config implies."""
    return config.projection_class_embeddings_input_dim - 6 * config.addition_time_embed_dim


def tiny_xl_unet_config(depth: int = 3) -> UNetConfig:
    """SDXL's layout at CPU-test widths: 3 levels (the first without
    attention), 2 layers a block (the LDM layout's), transformer depths
    (1, 2, `depth`) with the mid block at `depth`, every head 8 wide,
    linear projections, text_time with 4-wide time sinusoids and an 8-wide
    pooled embedding (4 x 6 + 8 = 32, the JAX tests' tiny XL widths)."""
    return UNetConfig(
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"),
        block_out_channels=(8, 16, 32),
        layers_per_block=2,
        transformer_layers_per_block=(1, 2, depth),
        cross_attention_dim=32,
        attention_head_dim=(1, 2, 4),
        use_linear_projection=True,
        norm_num_groups=4,
        addition_embed_type="text_time",
        addition_time_embed_dim=4,
        projection_class_embeddings_input_dim=4 * 6 + 8,
    )


@torch.no_grad()
def init_unet_(unet: torch.nn.Module, generator: torch.Generator,
               param_dtype: torch.dtype) -> None:
    """LeCun-normal weights (std 1/sqrt(fan_in), the JAX package's
    initializer) and zero biases in `param_dtype`, drawn layer by layer in
    module order; norms stay fp32 at weight 1, bias 0."""
    for mod in unet.modules():
        if isinstance(mod, (LoRALinear, LoRAConv2d)):
            w = mod.weight
            fan_in = w[0].numel()
            mod.weight = torch.nn.Parameter(
                torch.randn(w.shape, generator=generator, device=w.device)
                .mul_(1.0 / math.sqrt(fan_in)).to(param_dtype)
            )
            if mod.bias is not None:
                mod.bias = torch.nn.Parameter(
                    torch.zeros(mod.bias.shape, device=w.device, dtype=param_dtype)
                )
    unet.requires_grad_(False)


def make_random_bundle(
    config: Optional[UNetConfig] = None,
    spec: Optional[LoRASpec] = None,
    scheduler_kind: str = "ddim",
    prediction_type: str = "epsilon",
    dtype: torch.dtype = torch.float32,
    param_dtype: torch.dtype = torch.float32,
    attn_backend: Optional[str] = None,
    seed: int = 0,
    device: str | torch.device = "cpu",
) -> ModelBundle:
    """Random-weight ModelBundle. Defaults to the tiny CPU test UNet; pass
    `config=sd15_config()` for the full width. The attention backend
    defaults to the device's (the kernels on CUDA)."""
    config = config or tiny_unet_config()
    spec = spec or LoRASpec(rank=4, alpha=1.0)
    device = torch.device(device)
    attn_backend = attn_backend or default_backend(device)
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    with torch.device(device):
        unet = UNet2DConditionModel(config, dtype=dtype, attn_backend=attn_backend)
    init_unet_(unet, generator, param_dtype)
    apply_lora_spec(unet, spec, generator)  # the new LoRA parameters train
    return ModelBundle(
        unet=unet,
        scheduler=NoiseScheduler(scheduler_kind, prediction_type),
        spec=spec,
        device=device,
        encode_fn=fake_encode_fn(config.cross_attention_dim, device,
                                 xl_pooled_dim(config) if unet.is_xl else None),
    )


def make_sd15_bundle(dtype: torch.dtype = torch.bfloat16, **kw) -> ModelBundle:
    """Full-width SD1.5 bundle with random weights."""
    return make_random_bundle(config=sd15_config(), dtype=dtype,
                              param_dtype=dtype, **kw)


def make_sdxl_bundle(dtype: torch.dtype = torch.bfloat16, **kw) -> ModelBundle:
    """Full-width SDXL bundle with random weights and a fake encoder that
    gives PromptEmbedsXL."""
    return make_random_bundle(config=sdxl_config(), dtype=dtype, param_dtype=dtype, **kw)


# ---------------------------------------------------------------------------
# checkpoints on disk
# ---------------------------------------------------------------------------

# the words of the repo's example prompts: one token each
PROMPT_WORDS = ("van", "gogh", "1girl", "cat", "ears", "realistic", "real", "life",
                "instagram")
VOCAB_SIZE = 49408


def write_tokenizer(directory: str | os.PathLike, words=PROMPT_WORDS) -> None:
    """A synthetic CLIP tokenizer (`vocab.json`, `merges.txt`) in
    `directory`: byte-level base vocabulary, one merge chain per word, the
    two special tokens at CLIP's ids."""
    enc = _bytes_to_unicode()
    base = list(enc.values())
    vocab = {c: i for i, c in enumerate(base)}
    vocab.update({c + "</w>": len(base) + i for i, c in enumerate(base)})
    merges = []
    for word in words:
        pieces = [enc[b] for b in word.encode("utf-8")]
        pieces[-1] += "</w>"
        while len(pieces) > 1:
            merged = pieces[0] + pieces[1]
            if (pieces[0], pieces[1]) not in merges:
                merges.append((pieces[0], pieces[1]))
            vocab.setdefault(merged, len(vocab))
            pieces = [merged] + pieces[2:]
    vocab[SPECIAL_TOKENS[0]] = VOCAB_SIZE - 2
    vocab[SPECIAL_TOKENS[1]] = VOCAB_SIZE - 1
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))


def random_unet_state(config: UNetConfig, seed: int = 0, dtype: torch.dtype = torch.float16,
                      device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """A random UNet state_dict (diffusers keys, no LoRA) on the CPU:
    `init_unet_`'s weights, norms perturbed off 1 / 0."""
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    with torch.device(device):
        unet = UNet2DConditionModel(config)
    init_unet_(unet, generator, torch.float32)
    state = {}
    for k, v in unet.state_dict().items():
        if v.ndim == 1 and ("norm" in k.rsplit(".", 2)[-2]):
            v = v + 0.1 * torch.randn(v.shape, generator=generator, device=v.device)
        state[k] = v.to(dtype).cpu()
    return state


def random_clip_state(config: CLIPTextConfig, seed: int = 0,
                      dtype: torch.dtype = torch.float16,
                      device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """A random HF-keyed CLIP text-encoder state_dict on the CPU: N(0, 0.02)
    embeddings and weights, zero biases, LayerNorms at 1 + N(0, 0.1) / 0."""
    return _random_transformer_state(_shapes(lambda: CLIPTextModel(config)), seed, dtype,
                                     device)


def _shapes(module_fn) -> dict[str, torch.Size]:
    with torch.device("meta"):
        return {k: v.shape for k, v in module_fn().state_dict().items()}


def _random_transformer_state(shapes: dict, seed: int, dtype: torch.dtype,
                              device) -> dict[str, torch.Tensor]:
    """N(0, 0.02) embeddings and weights, zero biases, LayerNorms at
    1 + N(0, 0.1) / 0, drawn in key order, on the CPU."""
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    state = {}
    for k, shape in shapes.items():
        draw = torch.randn(shape, generator=generator, device=device)
        if "norm" in k.rsplit(".", 2)[-2]:
            v = 1 + 0.1 * draw if k.endswith("weight") else torch.zeros(shape, device=device)
        elif k.endswith("bias"):
            v = torch.zeros(shape, device=device)
        else:
            v = 0.02 * draw
        state[k] = v.to(dtype).cpu()
    return state


def write_single_file_checkpoint(
    path: str | os.PathLike,
    unet_config: Optional[UNetConfig] = None,
    text_config: Optional[CLIPTextConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float16,
    device: str | torch.device = "cpu",
) -> Path:
    """An SD2-style LDM single file with random weights: by default the
    full-width SD2.1 UNet and OpenCLIP ViT-H's 24-layer text tower with its
    `text_projection` (the loader keeps 23 layers), in `dtype`, plus a
    synthetic `tokenizer/` beside the file."""
    path = Path(path)
    unet_config = unet_config or sd21_config()
    text_config = text_config or sd2_text_config(24)
    unet = convert.diffusers_unet_to_ldm(random_unet_state(unet_config, seed, dtype, device))
    clip = random_clip_state(text_config, seed + 1, dtype, device)
    generator = torch.Generator().manual_seed(seed + 2)
    c = text_config.hidden_size
    clip["text_projection.weight"] = (0.02 * torch.randn((c, c), generator=generator)).to(dtype)
    tensors = {**unet, **convert.hf_clip_to_openclip(clip)}
    path.parent.mkdir(parents=True, exist_ok=True)
    write_safetensors(path, tensors)
    write_tokenizer(path.parent / "tokenizer")
    return path


def write_diffusers_checkpoint(
    root: str | os.PathLike,
    unet_config: UNetConfig,
    text_config: CLIPTextConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cpu",
) -> Path:
    """A diffusers directory with random weights in `dtype` (drawn on
    `device`): `unet/` and `text_encoder/` (config.json + weights) and a
    synthetic `tokenizer/`."""
    root = Path(root)
    _write_component(root / "unet", _unet_config_json(unet_config),
                     random_unet_state(unet_config, seed, dtype, device))
    _write_component(root / "text_encoder", _clip_config_json(text_config),
                     random_clip_state(text_config, seed + 1, dtype, device))
    write_tokenizer(root / "tokenizer")
    return root


def _write_component(directory: Path, config: dict, state: dict) -> None:
    """A diffusers component directory: `config.json` and its weights."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(config))
    fname = ("diffusion_pytorch_model.safetensors" if directory.name == "unet"
             else "model.safetensors")
    write_safetensors(directory / fname, state)


def _unet_config_json(config: UNetConfig) -> dict:
    return {
        "down_block_types": list(config.down_block_types),
        "up_block_types": list(config.up_block_types),
        "block_out_channels": list(config.block_out_channels),
        "layers_per_block": config.layers_per_block,
        "transformer_layers_per_block": config.transformer_layers_per_block,
        "cross_attention_dim": config.cross_attention_dim,
        "attention_head_dim": config.attention_head_dim,
        "use_linear_projection": config.use_linear_projection,
        "upcast_attention": config.upcast_attention,
        "norm_num_groups": config.norm_num_groups,
        "addition_embed_type": config.addition_embed_type,
        "addition_time_embed_dim": config.addition_time_embed_dim,
        "projection_class_embeddings_input_dim": config.projection_class_embeddings_input_dim,
    }


def _clip_config_json(config: CLIPTextConfig) -> dict:
    return {
        "architectures": ["CLIPTextModelWithProjection" if config.projection_dim
                          else "CLIPTextModel"],
        **{f: getattr(config, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "max_position_embeddings", "hidden_act", "eos_token_id",
            "projection_dim")},
    }


def _random_like(name: str, shape: tuple, generator: torch.Generator, device,
                 norm: bool, lecun: bool) -> torch.Tensor:
    """One random fp32 tensor on `device`: a norm parameter at 1 + N(0, 0.1)
    (weight) or N(0, 0.1) (bias); any other bias 0; a weight LeCun normal
    (`lecun`, std 1/sqrt(fan_in)) or N(0, 0.02)."""
    if norm:
        draw = torch.randn(shape, generator=generator, device=device)
        return (1 + 0.1 * draw) if name.endswith("weight") else 0.1 * draw
    if name.endswith("bias"):
        return torch.zeros(shape, device=device)
    draw = torch.randn(shape, generator=generator, device=device)
    if lecun:
        fan_in = math.prod(shape[1:])
        return draw * (1.0 / math.sqrt(fan_in))
    return 0.02 * draw


def write_sdxl_single_file(
    path: str | os.PathLike,
    unet_config: Optional[UNetConfig] = None,
    te1: Optional[CLIPTextConfig] = None,
    te2: Optional[CLIPTextConfig] = None,
    seed: int = 0,
    dtype: torch.dtype = torch.float16,
    device: str | torch.device = "cpu",
) -> Path:
    """An SDXL LDM single file with random weights, by default SDXL base at
    full width (the 2.57B UNet, CLIP-L, bigG with its projection: 6.8 GB in
    fp16), plus a synthetic `tokenizer/` and `tokenizer_2/` beside it. Each
    tensor is drawn on `device` (UNet weights LeCun normal, text towers
    N(0, 0.02), norms at 1 + N(0, 0.1) / N(0, 0.1), other biases 0) from one
    generator seeded `seed`, in the file's key order, and written before the
    next is drawn: host memory holds one tensor at a time."""
    path = Path(path)
    unet_config = unet_config or sdxl_config()
    te1 = te1 or sd1_text_config()
    te2 = te2 or sdxl_text2_config()
    with torch.device("meta"):
        unet_state = UNet2DConditionModel(unet_config).state_dict()
        te1_state = CLIPTextModel(te1).state_dict()
        te2_state = CLIPTextModel(te2).state_dict()
    # LDM key -> (shape, is a norm parameter, is a UNet weight)
    unet_names = convert.diffusers_unet_to_ldm({k: k for k in unet_state})
    specs = {ldm: (unet_state[k].shape, "norm" in k.rsplit(".", 2)[-2], True)
             for ldm, k in unet_names.items()}
    specs.update({convert.XL_CLIP_PREFIX + k: (v.shape, "norm" in k.rsplit(".", 2)[-2], False)
                  for k, v in te1_state.items()})
    for k, v in convert.hf_clip_to_openclip(te2_state, convert.XL_OPENCLIP_PREFIX).items():
        specs[k] = (v.shape, ".ln_" in f".{k.rsplit('.', 2)[-2]}", False)
    generator = torch.Generator(device)
    generator.manual_seed(seed)

    def fill(name: str) -> torch.Tensor:
        shape, norm, lecun = specs[name]
        return _random_like(name, tuple(shape), generator, device, norm, lecun).to(dtype)

    path.parent.mkdir(parents=True, exist_ok=True)
    write_safetensors(path, {k: torch.empty(s, dtype=dtype, device="meta")
                             for k, (s, _, _) in specs.items()}, fill=fill)
    write_tokenizer(path.parent / "tokenizer")
    write_tokenizer(path.parent / "tokenizer_2")
    return path


def write_sdxl_diffusers_checkpoint(
    root: str | os.PathLike,
    unet_config: UNetConfig,
    te1: CLIPTextConfig,
    te2: CLIPTextConfig,
    seed: int = 0,
) -> Path:
    """An SDXL diffusers directory with random fp32 weights: `unet/`
    (config.json with `addition_embed_type`), `text_encoder/`,
    `text_encoder_2/` (a `CLIPTextModelWithProjection` where `te2` has a
    projection) and synthetic `tokenizer/` and `tokenizer_2/`."""
    root = write_diffusers_checkpoint(root, unet_config, te1, seed)
    _write_component(root / "text_encoder_2", _clip_config_json(te2),
                     random_clip_state(te2, seed + 2, torch.float32))
    write_tokenizer(root / "tokenizer_2")
    return root


def random_vae_state(config: VAEDecoderConfig, seed: int = 0,
                     dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """A random VAE-decoder state_dict (diffusers keys) on the CPU: LeCun
    normal conv and linear weights, zero biases, GroupNorms at 1 + N(0, 0.1)
    and N(0, 0.1)."""
    generator = torch.Generator(device)
    generator.manual_seed(seed)
    state = {}
    for k, shape in _shapes(lambda: VAEDecoder(config)).items():
        draw = torch.randn(shape, generator=generator, device=device)
        if "norm" in k.rsplit(".", 2)[-2]:
            v = (1 if k.endswith("weight") else 0) + 0.1 * draw
        elif k.endswith("bias"):
            v = torch.zeros(shape, device=device)
        else:
            v = draw / math.sqrt(draw[0].numel())
        state[k] = v.to(dtype).cpu()
    return state


def write_vae_dir(root: str | os.PathLike, config: Optional[VAEDecoderConfig] = None,
                  seed: int = 0, dtype: torch.dtype = torch.float32,
                  device: str | torch.device = "cpu", legacy_attention: bool = False) -> Path:
    """`root/vae/`: a diffusers AutoencoderKL `config.json` and its decoder
    half (`decoder.*`, `post_quant_conv.*`) with random weights, SD1/2's
    widths by default. `legacy_attention` writes the mid-block attention
    under the old names (query/key/value/proj_attn). -> the `vae/` dir."""
    config = config or VAEDecoderConfig()
    d = Path(root) / "vae"
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps({
        "_class_name": "AutoencoderKL", "in_channels": 3,
        **{f: getattr(config, f) for f in ("latent_channels", "out_channels",
                                            "layers_per_block", "norm_num_groups",
                                            "scaling_factor")},
        "block_out_channels": list(config.block_out_channels),
    }))
    state = random_vae_state(config, seed, dtype, device)
    if legacy_attention:
        old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        for new, name in old.items():
            for leaf in ("weight", "bias"):
                prefix = "decoder.mid_block.attentions.0"
                state[f"{prefix}.{name}.{leaf}"] = state.pop(f"{prefix}.{new}.{leaf}")
    write_safetensors(d / "diffusion_pytorch_model.safetensors", state)
    return d


def random_clip_vision_state(config: CLIPVisionConfig, seed: int = 0,
                             dtype: torch.dtype = torch.float32,
                             device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """A random HF-keyed CLIP vision state_dict on the CPU: N(0, 0.02)
    embeddings and weights, zero biases, LayerNorms at 1 + N(0, 0.1) / 0."""
    return _random_transformer_state(_shapes(lambda: CLIPVisionModel(config)), seed, dtype,
                                     device)


def write_clip_dir(root: str | os.PathLike, text_config: Optional[CLIPTextConfig] = None,
                   vision_config: Optional[CLIPVisionConfig] = None,
                   projection_dim: int = 768, seed: int = 0,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cpu") -> Path:
    """A CLIP dual-encoder directory with random weights (openai/clip-vit-
    large-patch14's layout): `config.json` (`text_config`, `vision_config`,
    `projection_dim`), `model.safetensors` (`text_model.*`,
    `text_projection.weight`, `vision_model.*`, `visual_projection.weight`)
    and a synthetic tokenizer. By default ViT-L/14 (24 x 1024) and the
    12 x 768 text tower, projection 768."""
    text_config = dataclasses.replace(text_config or CLIPTextConfig(),
                                      projection_dim=projection_dim)
    vision_config = dataclasses.replace(vision_config or CLIPVisionConfig(),
                                        projection_dim=projection_dim)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps({
        "architectures": ["CLIPModel"], "projection_dim": projection_dim,
        "text_config": {f: getattr(text_config, f) for f in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "max_position_embeddings", "hidden_act", "eos_token_id")},
        "vision_config": {f: getattr(vision_config, f) for f in (
            "hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
            "image_size", "patch_size", "hidden_act")},
    }))
    state = {**random_clip_state(text_config, seed, dtype, device),
             **random_clip_vision_state(vision_config, seed + 1, dtype, device)}
    write_safetensors(root / "model.safetensors", state)
    write_tokenizer(root)
    return root
