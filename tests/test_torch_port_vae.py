"""The port's VAE decoder against the JAX package's.

One tiny decoder (8-16 channels, 4 levels, 1 resnet + 1 per level) on the
JAX package's own init with every leaf perturbed from a numpy seed; the
port takes it through `flax_vae_decoder_to_torch`. fp32 forward within
1e-5 x max|out| (the same convs and norms, summed in other orders); a
random `vae/` directory written by `leco_tpu_torch.testing.write_vae_dir`,
loaded by both packages' `load_vae_decoder` and decoded by both
`decode_latents`: the same uint8 image except +-1 where a value sits at a
rounding tie."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from leco_tpu.infer import decode_latents as jax_decode
from leco_tpu.models.loader import load_vae_decoder as jax_load_vae
from leco_tpu.models.vae import VAEDecoder as JaxVAE
from leco_tpu.models.vae import VAEDecoderConfig as JaxVAEConfig
from leco_tpu_torch import infer, testing
from leco_tpu_torch.models.convert import flax_vae_decoder_to_torch
from leco_tpu_torch.models.loader import load_vae_decoder
from leco_tpu_torch.models.vae import VAEDecoder, VAEDecoderConfig

TINY = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
RTOL = 1e-5


@pytest.fixture(scope="module")
def shared():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((2, 4, 5, 4)).astype(np.float32)  # NHWC, h 4 w 5
    jvae = JaxVAE(config=JaxVAEConfig(**TINY))
    params = jvae.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
    flat = {k: np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
            for k, v in flatten_dict(params).items()}
    params = unflatten_dict(flat)
    want = np.asarray(jax.jit(jvae.apply)({"params": params}, jnp.asarray(z)))
    return dict(params=params, z=z, want=want)


def test_state_dict_carries_over_exactly(shared):
    sd = flax_vae_decoder_to_torch(shared["params"])
    port = VAEDecoder(VAEDecoderConfig(**TINY))
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd, strict=True)


def test_decoder_matches_jax(shared):
    port = VAEDecoder(VAEDecoderConfig(**TINY))
    port.load_state_dict(flax_vae_decoder_to_torch(shared["params"]))
    with torch.no_grad():
        got = port(torch.from_numpy(shared["z"].transpose(0, 3, 1, 2))).numpy()
    want = shared["want"]
    assert got.shape == (2, 3, 32, 40)  # the 8x upscale
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=RTOL * np.abs(want).max())


def test_sd_vae_parameter_count():
    """diffusers SD1.5 AutoencoderKL decoder + post_quant_conv: 49.49M (the
    JAX package's count, tests/test_vae_infer.py)."""
    with torch.device("meta"):
        vae = VAEDecoder(VAEDecoderConfig())
    assert sum(p.numel() for p in vae.parameters()) == 49_490_199


@pytest.mark.parametrize("legacy", [False, True])
def test_one_vae_dir_decodes_alike_in_both_packages(tmp_path, legacy):
    cfg = VAEDecoderConfig(**TINY, scaling_factor=0.13025)
    testing.write_vae_dir(tmp_path, cfg, seed=1, legacy_attention=legacy)
    port = load_vae_decoder(str(tmp_path), device="cpu")
    assert port.config == cfg
    jvae, jparams = jax_load_vae(str(tmp_path))
    assert jvae.config.scaling_factor == cfg.scaling_factor
    latents = np.random.default_rng(2).standard_normal((1, 4, 8, 8)).astype(np.float32)
    got = infer.decode_latents(None, torch.from_numpy(latents), vae=port)
    want = jax_decode(None, jnp.asarray(latents.transpose(0, 2, 3, 1)), vae=jvae,
                      vae_params=jparams)
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 64, 64, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-2
    assert len(np.unique(got)) > 16  # not a clipped flat image


def test_load_vae_decoder_finds_a_standalone_dir_and_refuses_none(tmp_path):
    vae_dir = testing.write_vae_dir(tmp_path, VAEDecoderConfig(**TINY))
    assert load_vae_decoder(str(vae_dir), device="cpu").config.block_out_channels == (8, 8, 16, 16)
    with pytest.raises(FileNotFoundError):
        load_vae_decoder(str(tmp_path / "missing"), device="cpu")


def test_bf16_weights_and_fp32_norms(tmp_path):
    testing.write_vae_dir(tmp_path, VAEDecoderConfig(**TINY))
    vae = load_vae_decoder(str(tmp_path), torch.bfloat16, device="cpu")
    dec = vae.decoder
    assert dec.conv_in.weight.dtype == torch.bfloat16
    assert dec.up_blocks[0].upsamplers[0].conv.weight.dtype == torch.bfloat16
    assert dec.mid_block.attentions[0].group_norm.weight.dtype == torch.float32
    out = vae(torch.zeros(1, 4, 4, 4))
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 32, 32)


def test_decode_latents_needs_a_vae():
    with pytest.raises(ValueError, match="vae"):
        infer.decode_latents(None, torch.zeros(1, 4, 4, 4))
