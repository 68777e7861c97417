"""Checkpoint loading: diffusers directories and LDM single files.

Counterpart of `leco_tpu/models/loader.py` (the reference's
model_util.load_models, model_util.py:104-129, and load_models_xl,
model_util.py:179-227). Offline: every tensor and the tokenizers come from
the local path.

  * diffusers directory: `unet/config.json` + weights, `text_encoder/`
    likewise, `tokenizer/vocab.json` + `merges.txt`; weights in
    `.safetensors` (read by the port's own reader), `.bin` (torch.load
    with weights_only=True), or shards named by a `*.index.json`;
  * LDM single file (`.safetensors` or `.ckpt`): keys remapped by
    `models/convert.py`, the UNet config fixed by the `v2` flag and checked
    against the tensors, and a `tokenizer/` directory beside the file;
  * SDXL (`load_models_xl`): a diffusers directory with `text_encoder_2/`
    and `tokenizer_2/` (pad id 0), or an SDXL single file (CLIP-L under
    `conditioner.embedders.0.transformer.*`, bigG under
    `conditioner.embedders.1.model.*`) with `tokenizer/` and
    `tokenizer_2/` beside it; the SD1/2 loader refuses an SDXL file;
  * the VAE decoder (`load_vae_decoder`): a diffusers dir's `vae/`, or a
    standalone VAE dir, for inference.

The UNet is built on the meta device and takes the checkpoint's tensors as
its parameters (`load_state_dict(assign=True)`), so a full-width model is
never held twice. Conv and linear weights take `weight_dtype`; norm
parameters are rounded to `weight_dtype` (as the JAX package stores them)
and kept fp32, the port's norm convention. The LoRA branches come from
`apply_lora_spec` with a `torch.Generator` seeded 0.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from leco_tpu_torch.lora import LoRASpec, _LoRALayer, apply_lora_spec, read_safetensors
from leco_tpu_torch.models import convert
from leco_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    sd1_text_config,
    sd2_text_config,
    sdxl_text2_config,
)
from leco_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from leco_tpu_torch.models.tokenizer import CLIPTokenizer
from leco_tpu_torch.models.unet import (
    UNet2DConditionModel,
    UNetConfig,
    sd15_config,
    sd21_config,
    sdxl_config,
)
from leco_tpu_torch.models.vae import GroupNorm as VAEGroupNorm
from leco_tpu_torch.models.vae import VAEDecoder, VAEDecoderConfig
from leco_tpu_torch.ops.schedulers import NoiseScheduler, create_noise_scheduler

COMPONENT_FILES = (
    "diffusion_pytorch_model.safetensors",
    "model.safetensors",
    "diffusion_pytorch_model.bin",
    "pytorch_model.bin",
    "model.fp16.safetensors",
)


# ---------------------------------------------------------------------------
# tensor files
# ---------------------------------------------------------------------------


def load_tensor_file(path: str) -> dict[str, torch.Tensor]:
    """A `.safetensors` file, or a torch pickle (`.ckpt`, `.bin`; a
    top-level "state_dict" is unwrapped), -> {name: CPU tensor}."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)[0]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def load_component_tensors(component_dir: str) -> dict[str, torch.Tensor]:
    """A diffusers component directory, sharded checkpoints included."""
    for fname in COMPONENT_FILES:
        p = os.path.join(component_dir, fname)
        if os.path.exists(p):
            return load_tensor_file(p)
    for fname in sorted(os.listdir(component_dir)):
        if fname.endswith(".index.json"):
            with open(os.path.join(component_dir, fname)) as f:
                index = json.load(f)
            out: dict[str, torch.Tensor] = {}
            for shard in sorted(set(index["weight_map"].values())):
                out.update(load_tensor_file(os.path.join(component_dir, shard)))
            return out
    raise FileNotFoundError(f"no model weights found in {component_dir}")


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def unet_config_from_json(config: dict) -> UNetConfig:
    def tup(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    return UNetConfig(
        sample_size=config.get("sample_size", 64),
        in_channels=config.get("in_channels", 4),
        out_channels=config.get("out_channels", 4),
        down_block_types=tuple(config["down_block_types"]),
        up_block_types=tuple(config["up_block_types"]),
        block_out_channels=tuple(config["block_out_channels"]),
        layers_per_block=config.get("layers_per_block", 2),
        transformer_layers_per_block=tup(config.get("transformer_layers_per_block", 1)),
        cross_attention_dim=config.get("cross_attention_dim", 768),
        # the HEAD COUNT (diffusers-legacy naming, right for every SD-family
        # config.json); the modern explicit num_attention_heads wins if set
        attention_head_dim=tup(
            config.get("num_attention_heads") or config.get("attention_head_dim", 8)),
        use_linear_projection=config.get("use_linear_projection", False),
        upcast_attention=config.get("upcast_attention", False) or False,
        addition_embed_type=config.get("addition_embed_type"),
        addition_time_embed_dim=config.get("addition_time_embed_dim") or 256,
        projection_class_embeddings_input_dim=(
            config.get("projection_class_embeddings_input_dim") or 2816),
        norm_num_groups=config.get("norm_num_groups", 32),
    )


def clip_config_from_json(config: dict, clip_skip: Optional[int] = None) -> CLIPTextConfig:
    num_layers = config.get("num_hidden_layers", 12)
    # the reference's clip-skip arithmetic (model_util.py:48,62): clip_skip=k
    # drops the last k-1 layers. SD2-family configs often ship already cut
    # to 23 layers, so clip_skip on top of one stacks: check what is left.
    if clip_skip is not None:
        num_layers = num_layers - (clip_skip - 1)
        if num_layers < 1:
            raise ValueError(
                f"clip_skip={clip_skip} would leave {num_layers} encoder layers "
                f"(config has {config.get('num_hidden_layers', 12)}); the "
                "checkpoint's text-encoder config may already be truncated — use "
                "a smaller clip_skip or none.")
    return CLIPTextConfig(
        vocab_size=config.get("vocab_size", 49408),
        hidden_size=config.get("hidden_size", 768),
        intermediate_size=config.get("intermediate_size", 3072),
        num_hidden_layers=num_layers,
        num_attention_heads=config.get("num_attention_heads", 12),
        max_position_embeddings=config.get("max_position_embeddings", 77),
        hidden_act=config.get("hidden_act", "quick_gelu"),
        projection_dim=(
            config.get("projection_dim")
            if config.get("architectures", [""])[0] == "CLIPTextModelWithProjection"
            else None),
        eos_token_id=config.get("eos_token_id", 49407),
    )


# ---------------------------------------------------------------------------
# building the modules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoadedModels:
    """What `load_models` / `load_models_xl` return (the reference's
    (tokenizer, text_encoder, unet, scheduler) tuple, and SDXL's second
    tokenizer and text encoder), every module on its device."""

    tokenizer: CLIPTokenizer
    text_encoder: CLIPTextModel
    unet: UNet2DConditionModel  # with its LoRA branches
    scheduler: NoiseScheduler
    unet_config: UNetConfig
    tokenizer_2: Optional[CLIPTokenizer] = None  # SDXL
    text_encoder_2: Optional[CLIPTextModel] = None  # SDXL: bigG with its projection

    @property
    def is_xl(self) -> bool:
        return self.unet.is_xl


def _assign(module: torch.nn.Module, sd: dict, dtypes: dict, device, what: str) -> None:
    """Make `sd`'s tensors (cast per `dtypes`, on `device`) the parameters of
    a module built on the meta device."""
    want = module.state_dict()
    missing = sorted(set(want) - set(sd))
    if missing:
        raise ValueError(f"{what}: {len(missing)} tensor(s) missing from the checkpoint: "
                         f"{missing[:10]}")
    state = {}
    for name, ref in want.items():
        t = sd[name]
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, the model "
                             f"wants {tuple(ref.shape)}")
        dtype, store = dtypes[name]
        state[name] = t.to(device).to(dtype).to(store).contiguous()
    module.load_state_dict(state, strict=True, assign=True)
    module.requires_grad_(False)


def build_unet(config: UNetConfig, sd: dict[str, torch.Tensor], spec: Optional[LoRASpec],
               weight_dtype: torch.dtype, attn_backend: str, device,
               checkpoint_unet: bool = False) -> UNet2DConditionModel:
    """A diffusers-keyed UNet state_dict -> the port's UNet on `device`, with
    the LoRA branches of `spec` (fp32 masters) added, drawn from a generator
    seeded 0 (the JAX loader's `_build_unet` seed). `checkpoint_unet` is the
    JAX loader's `remat`."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(config, dtype=weight_dtype, attn_backend=attn_backend,
                                    checkpoint_unet=checkpoint_unet)
    layer_params = {f"{name}.{leaf}" for name, mod in unet.named_modules()
                    if isinstance(mod, _LoRALayer) for leaf in ("weight", "bias")}
    unexpected = sorted(set(sd) - set(unet.state_dict()))
    if unexpected:
        raise ValueError(f"UNet: {len(unexpected)} checkpoint tensor(s) the model does "
                         f"not have: {unexpected[:10]}")
    dtypes = {name: (weight_dtype, weight_dtype if name in layer_params else torch.float32)
              for name in unet.state_dict()}
    _assign(unet, sd, dtypes, device, "UNet")
    if spec is not None:
        generator = torch.Generator(device)
        generator.manual_seed(0)
        apply_lora_spec(unet, spec, generator)
    return unet


def build_text_encoder(config: CLIPTextConfig, sd: dict[str, torch.Tensor],
                       weight_dtype: torch.dtype, device) -> CLIPTextModel:
    """HF CLIP keys -> the port's CLIPTextModel. Layers past
    `config.num_hidden_layers` and buffers such as `position_ids` are left
    out, as the JAX package's `torch_clip_to_flax` leaves them."""
    with torch.device("meta"):
        model = CLIPTextModel(config)
    dtypes = {name: (weight_dtype, weight_dtype) for name in model.state_dict()}
    _assign(model, sd, dtypes, device, "text encoder")
    return model


def build_clip_vision(config: CLIPVisionConfig, sd: dict[str, torch.Tensor],
                      weight_dtype: torch.dtype, device) -> CLIPVisionModel:
    """HF CLIP keys (`vision_model.*`, `visual_projection.weight`; other
    keys are left out) -> the port's CLIPVisionModel, every parameter in
    `weight_dtype`."""
    with torch.device("meta"):
        model = CLIPVisionModel(config)
    dtypes = {name: (weight_dtype, weight_dtype) for name in model.state_dict()}
    _assign(model, sd, dtypes, device, "CLIP vision tower")
    return model


def _scheduler(name: str, v_pred: bool) -> NoiseScheduler:
    return create_noise_scheduler(
        name, prediction_type="v_prediction" if v_pred else "epsilon")


# ---------------------------------------------------------------------------
# public loader
# ---------------------------------------------------------------------------


def load_models(
    pretrained_model_name_or_path: str,
    scheduler_name: str = "ddim",
    v2: bool = False,
    v_pred: bool = False,
    weight_dtype: torch.dtype = torch.float32,
    clip_skip: Optional[int] = None,
    lora_spec: Optional[LoRASpec] = None,
    attn_backend: str = "xla",
    device: str | torch.device = "cpu",
    checkpoint_unet: bool = False,
) -> LoadedModels:
    """SD1.x/2.x loader (model_util.load_models): a diffusers directory or
    a single `.ckpt` / `.safetensors` LDM file. `checkpoint_unet` (the
    config's `train.checkpoint_unet`, the JAX loader's `remat`) builds a UNet
    that recomputes its blocks in the backward."""
    path = pretrained_model_name_or_path
    device = torch.device(device)
    if path.endswith(".ckpt") or path.endswith(".safetensors"):
        return _load_single_file(path, scheduler_name, v2, v_pred, weight_dtype,
                                 clip_skip, lora_spec, attn_backend, device,
                                 checkpoint_unet)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local diffusers directory or checkpoint file. "
            "leco-tpu is offline-only: download the model first.")

    with open(os.path.join(path, "unet", "config.json")) as f:
        unet_config = unet_config_from_json(json.load(f))
    unet = build_unet(unet_config, load_component_tensors(os.path.join(path, "unet")),
                      lora_spec, weight_dtype, attn_backend, device, checkpoint_unet)

    with open(os.path.join(path, "text_encoder", "config.json")) as f:
        te_config = clip_config_from_json(json.load(f), clip_skip)
    te = build_text_encoder(
        te_config, load_component_tensors(os.path.join(path, "text_encoder")),
        weight_dtype, device)
    return LoadedModels(
        tokenizer=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer")),
        text_encoder=te, unet=unet, scheduler=_scheduler(scheduler_name, v_pred),
        unet_config=unet_config)


def _load_single_file(path, scheduler_name, v2, v_pred, weight_dtype, clip_skip,
                      lora_spec, attn_backend, device, checkpoint_unet) -> LoadedModels:
    sd = load_tensor_file(path)
    if any(k.startswith("conditioner.embedders.1.") for k in sd):
        raise ValueError(
            f"{path} is an SDXL single-file checkpoint; use load_models_xl "
            "(train_lora_xl) instead of the SD1/2 loader.")

    unet_sd = convert.ldm_unet_to_diffusers(sd)
    cross_dim = unet_sd["down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"].shape[1]
    use_linear = unet_sd["down_blocks.0.attentions.0.proj_in.weight"].ndim == 2
    unet_config = sd21_config() if v2 else sd15_config()
    if unet_config.cross_attention_dim != cross_dim:
        raise ValueError(
            f"checkpoint cross-attention dim is {cross_dim} but v2={v2} "
            f"implies {unet_config.cross_attention_dim}. If this is an SD2.x "
            "checkpoint, set pretrained_model.v2: true in the config (the "
            "reference requires the same flag, config_util.py:17); if it is "
            "SD1.x, unset it.")
    if unet_config.use_linear_projection != use_linear:
        raise ValueError(
            f"checkpoint transformer proj_in is "
            f"{'linear' if use_linear else 'conv'} but the v2={v2} config "
            f"expects {'linear' if unet_config.use_linear_projection else 'conv'} "
            "— the v2 flag likely does not match the checkpoint.")
    unet = build_unet(unet_config, unet_sd, lora_spec, weight_dtype, attn_backend, device,
                      checkpoint_unet)
    del unet_sd

    if v2:
        te_sd = convert.ldm_openclip_to_hf(sd)
        te_config = sd2_text_config(24 - (clip_skip - 1) if clip_skip is not None else 23)
    else:
        te_sd = convert.ldm_clip_to_hf(sd)
        te_config = sd1_text_config(12 - (clip_skip - 1) if clip_skip is not None else 12)
    del sd
    te = build_text_encoder(te_config, te_sd, weight_dtype, device)

    # single-file checkpoints carry no tokenizer; look for one beside the file
    tok_dir = os.path.join(os.path.dirname(os.path.abspath(path)), "tokenizer")
    if not os.path.isdir(tok_dir):
        raise FileNotFoundError(
            "single-file checkpoints need a tokenizer/ directory (vocab.json "
            f"+ merges.txt) next to the checkpoint; none found at {tok_dir}. "
            "(The reference downloaded it from the HF hub, model_util.py:19-20; "
            "this framework is offline-only.)")
    return LoadedModels(
        tokenizer=CLIPTokenizer.from_pretrained(tok_dir), text_encoder=te, unet=unet,
        scheduler=_scheduler(scheduler_name, v_pred), unet_config=unet_config)


def load_models_xl(
    pretrained_model_name_or_path: str,
    scheduler_name: str = "ddim",
    weight_dtype: torch.dtype = torch.float32,
    lora_spec: Optional[LoRASpec] = None,
    attn_backend: str = "xla",
    device: str | torch.device = "cpu",
    checkpoint_unet: bool = True,
) -> LoadedModels:
    """SDXL loader (model_util.load_models_xl, model_util.py:200-227): a
    diffusers directory (`unet/` with `addition_embed_type`, `text_encoder/`,
    `text_encoder_2/`, `tokenizer/`, `tokenizer_2/`) or an SDXL single
    file. `tokenizer_2` pads with id 0 (model_util.py:150). The scheduler
    predicts epsilon. `checkpoint_unet` defaults on, as the JAX loader's
    `remat` does; the CLI passes the config's."""
    path = pretrained_model_name_or_path
    device = torch.device(device)
    if path.endswith(".ckpt") or path.endswith(".safetensors"):
        return _load_single_file_xl(path, scheduler_name, weight_dtype, lora_spec,
                                    attn_backend, device, checkpoint_unet)
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local diffusers directory or checkpoint file. "
            "leco-tpu is offline-only: download the model first.")

    with open(os.path.join(path, "unet", "config.json")) as f:
        unet_config = unet_config_from_json(json.load(f))
    unet = build_unet(unet_config, load_component_tensors(os.path.join(path, "unet")),
                      lora_spec, weight_dtype, attn_backend, device, checkpoint_unet)
    encoders = []
    for sub in ("text_encoder", "text_encoder_2"):
        with open(os.path.join(path, sub, "config.json")) as f:
            te_config = clip_config_from_json(json.load(f))
        encoders.append(build_text_encoder(
            te_config, load_component_tensors(os.path.join(path, sub)), weight_dtype,
            device))
    return LoadedModels(
        tokenizer=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer")),
        text_encoder=encoders[0], unet=unet, scheduler=_scheduler(scheduler_name, False),
        unet_config=unet_config,
        tokenizer_2=CLIPTokenizer.from_pretrained(os.path.join(path, "tokenizer_2"),
                                                  pad_token_id=0),
        text_encoder_2=encoders[1])


def _sibling_tokenizer(path: str, sub: str, pad_token_id=None) -> CLIPTokenizer:
    tok_dir = os.path.join(os.path.dirname(os.path.abspath(path)), sub)
    if not os.path.isdir(tok_dir):
        raise FileNotFoundError(
            f"single-file checkpoints need a {sub}/ directory (vocab.json + "
            f"merges.txt) next to the checkpoint; none found at {tok_dir}. "
            "(The reference downloaded it from the HF hub; this framework is "
            "offline-only.)")
    return CLIPTokenizer.from_pretrained(tok_dir, pad_token_id=pad_token_id)


def _load_single_file_xl(path, scheduler_name, weight_dtype, lora_spec, attn_backend,
                         device, checkpoint_unet) -> LoadedModels:
    """An SDXL `.safetensors` / `.ckpt` (the reference's
    StableDiffusionXLPipeline.from_single_file, model_util.py:179-197)."""
    sd = load_tensor_file(path)
    if not any(k.startswith(convert.XL_OPENCLIP_PREFIX) for k in sd):
        raise ValueError(f"{path} does not look like an SDXL checkpoint")
    unet_config = sdxl_config()
    unet = build_unet(unet_config, convert.ldm_unet_to_diffusers(sd), lora_spec,
                      weight_dtype, attn_backend, device, checkpoint_unet)
    te1_sd = convert.ldm_clip_to_hf(sd, prefix=convert.XL_CLIP_PREFIX)
    te2_sd = convert.ldm_openclip_to_hf(sd, prefix=convert.XL_OPENCLIP_PREFIX)
    del sd
    te1 = build_text_encoder(sd1_text_config(), te1_sd, weight_dtype, device)
    del te1_sd
    te2 = build_text_encoder(sdxl_text2_config(), te2_sd, weight_dtype, device)
    return LoadedModels(
        tokenizer=_sibling_tokenizer(path, "tokenizer"), text_encoder=te1, unet=unet,
        scheduler=_scheduler(scheduler_name, False), unet_config=unet_config,
        tokenizer_2=_sibling_tokenizer(path, "tokenizer_2", pad_token_id=0),
        text_encoder_2=te2)


def load_vae_decoder(pretrained_model_name_or_path: str,
                     weight_dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> VAEDecoder:
    """The VAE decoder of a diffusers dir's `vae/` subfolder, or of a
    standalone VAE dir (a `config.json` with `latent_channels` or
    `scaling_factor`), on `device`: conv and linear weights in
    `weight_dtype`, norm parameters rounded to it and kept fp32. Raises
    FileNotFoundError where there is none."""
    path = pretrained_model_name_or_path
    for sub in ("vae", ""):
        d = os.path.join(path, sub) if sub else path
        if os.path.exists(os.path.join(d, "config.json")):
            with open(os.path.join(d, "config.json")) as f:
                cfg_json = json.load(f)
            if "latent_channels" in cfg_json or "scaling_factor" in cfg_json:
                path = d
                break
    else:
        raise FileNotFoundError(f"no VAE config.json under {path}")
    config = VAEDecoderConfig(
        latent_channels=cfg_json.get("latent_channels", 4),
        out_channels=cfg_json.get("out_channels", 3),
        block_out_channels=tuple(cfg_json.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg_json.get("layers_per_block", 2),
        norm_num_groups=cfg_json.get("norm_num_groups", 32),
        scaling_factor=cfg_json.get("scaling_factor", 0.18215),
    )
    sd = convert.vae_decoder_state(load_component_tensors(path))
    with torch.device("meta"):
        vae = VAEDecoder(config, dtype=weight_dtype)
    norms = {f"{name}.{leaf}" for name, mod in vae.named_modules()
             if isinstance(mod, VAEGroupNorm) for leaf in ("weight", "bias")}
    dtypes = {name: (weight_dtype, torch.float32 if name in norms else weight_dtype)
              for name in vae.state_dict()}
    _assign(vae, sd, dtypes, torch.device(device), "VAE decoder")
    return vae
