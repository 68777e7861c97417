"""CLI entry point of the port: SD v1.x / v2.x LoRA-ESD training.

    python -m leco_tpu_torch.train_lora --config_file <yaml> [--device cuda]
    torchrun --nproc_per_node N -m leco_tpu_torch.train_lora --config_file <yaml>

The JAX package's `train_lora.py` (the reference's one flag,
train_lora.py:333-343) plus `--device`, the port's counterpart of
`JAX_PLATFORMS`: `cuda` (the default) raises when there is no GPU rather
than running on the CPU; the CPU tests pass `--device cpu`. The steps are
the JAX CLI's: config, prompts, precision, LoRA spec, the attention choice
(`use_flash_attention`, else `use_xformers`, else the device's default),
`load_models` (with `train.checkpoint_unet` as the JAX CLI passes it, its
`remat`), the parameter summaries, then `train`. Before any weight loads it
refuses what the port does not run: `step_chunk > 1`.

Under a launcher (torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) it starts torch.distributed (`parallel/distributed.py`: NCCL
on `cuda:LOCAL_RANK`, gloo for `--device cpu`) and builds the JAX CLI's mesh
over the processes (`parallel/mesh.py::mesh_axes`): `spatial_parallel` (0
is auto, n // 2) gives a (dp, sp) mesh, `data_parallel` or
`tensor_parallel > 1` a (dp, tp) mesh, sp and tp are exclusive, SDXL takes
dp and tp only; tp cuts the transformer blocks' weights to each rank's
share (`parallel/sharding.py`). With no mesh (or one process) a run is the
unsharded one.
"""

from __future__ import annotations

import argparse

import torch


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available; pass --device cpu to run "
            "on the CPU")
    return device


def main(args, on_step=None, xl: bool = False) -> dict:
    """Train as the config says; returns `train()`'s result. `on_step(i,
    loss)` is `train()`'s optional observer hook. `xl` loads the model with
    `load_models_xl` (`leco_tpu_torch.train_lora_xl`)."""
    from leco_tpu_torch.config import load_config_from_yaml, parse_precision
    from leco_tpu_torch.lora import LoRASpec
    from leco_tpu_torch.models.loader import load_models, load_models_xl
    from leco_tpu_torch.ops.attention import default_backend
    from leco_tpu_torch.parallel import distributed, mesh as mesh_lib
    from leco_tpu_torch.parallel.context import ParallelContext
    from leco_tpu_torch.parallel.sharding import shard_unet
    from leco_tpu_torch.prompts import load_prompts_from_yaml
    from leco_tpu_torch.train.trainer import ModelBundle, _refuse_unported, train
    from leco_tpu_torch.utils.debug import check_frozen_params, check_trainable_params

    device = distributed.maybe_initialize_distributed(resolve_device(args.device))
    config = load_config_from_yaml(args.config_file)
    _refuse_unported(config)  # before loading gigabytes of weights
    axes = mesh_lib.mesh_axes(config.train.data_parallel, config.train.tensor_parallel,
                              config.train.spatial_parallel, distributed.world_size(), xl=xl)
    prompts = load_prompts_from_yaml(config.prompts_file)
    weight_dtype = parse_precision(config.train.precision)
    spec = LoRASpec(
        rank=config.network.rank,
        alpha=config.network.alpha,
        network_type=config.network.type,
        train_method=config.network.training_method,
    )
    use_flash = config.other.use_flash_attention
    if use_flash is None:
        use_flash = config.other.use_xformers or default_backend(device) == "flash"

    load_kw = dict(
        scheduler_name=config.train.noise_scheduler,
        weight_dtype=weight_dtype,
        lora_spec=spec,
        attn_backend="flash" if use_flash else "xla",
        device=device,
        checkpoint_unet=config.train.checkpoint_unet,
    )
    model = config.pretrained_model
    if xl:
        models = load_models_xl(model.name_or_path, **load_kw)
    else:
        models = load_models(model.name_or_path, v2=model.v2, v_pred=model.v_pred,
                             clip_skip=model.clip_skip, **load_kw)
    bundle = ModelBundle.from_loaded(models, spec, device)
    del models  # train() frees the text encoder(s) once the prompts are encoded
    if distributed.rank() == 0:
        check_trainable_params(bundle.unet)
        check_frozen_params(bundle.unet)
    if axes is not None and distributed.world_size() > 1:
        mesh = mesh_lib.ProcessMesh(*axes, device)
        shard_unet(bundle.unet, mesh)
        bundle.unet.set_parallel(ParallelContext(mesh, len(bundle.unet.cfg.block_out_channels)))
    return train(config, prompts, bundle, on_step=on_step)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True, help="Config file for training.")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; no fallback)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
