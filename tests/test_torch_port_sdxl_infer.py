"""The port's SDXL inference against the JAX package's (`leco_tpu/infer.py`).

One tiny SDXL diffusers directory (`leco_tpu_torch.testing`) is loaded by
both packages with rank-2 lierla LoRA, fp32. `generate_latents` runs end to
end on both sides (both towers' encodings, the pooled (uncond, cond) pair,
the time_ids of the size, DDIM at guidance 7, 3 steps, 64 px) from the same
numpy initial latents, with no LoRA, at -1 and +1 and in the list form, and
is held within 1e-4 x max|ref| + 1e-5 (fp32: the same UNet in other
summation orders). Then `positive_embeds` on XL, the A/B grid, and the
`scripts/infer_xl.py` counterpart writing PNGs on the CPU."""

import numpy as np
import pytest
import torch

from leco_tpu import infer as jax_infer
from leco_tpu import lora as jax_lora
from leco_tpu.models import loader as jax_loader
from leco_tpu_torch import infer, lora, testing
from leco_tpu_torch.models import loader
from leco_tpu_torch.models.vae import VAEDecoderConfig
from leco_tpu_torch.scripts import infer_xl
from leco_tpu_torch.train import diffusion as diff
from tests.test_torch_port_sdxl_loader import write_tiny_xl_dir
from test_torch_port_lora_tree import to_flax

SPEC = dict(rank=2, alpha=1.0)
GEN = infer.GenerationConfig(height=64, width=64, num_inference_steps=3, guidance_scale=7.0,
                             seed=7)
RTOL, ATOL = 1e-4, 1e-5
TINY_VAE = VAEDecoderConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                            norm_num_groups=4, scaling_factor=0.13025)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: these tiny models are dispatch-bound, and the
    suite runs several workers on one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = write_tiny_xl_dir(tmp_path_factory.mktemp("xl_infer"), seed=13)
    testing.write_vae_dir(root, TINY_VAE)
    return root


@pytest.fixture(scope="module")
def models(ckpt):
    pm = loader.load_models_xl(str(ckpt), lora_spec=lora.LoRASpec(**SPEC), device="cpu",
                               checkpoint_unet=False)
    jm = jax_loader.load_models_xl(str(ckpt), lora_spec=jax_lora.LoRASpec(**SPEC), remat=False)
    rng = np.random.default_rng(0)
    trees = [{k: torch.from_numpy((0.05 * rng.standard_normal(v.shape)).astype(np.float32))
              for k, v in lora.lora_parameters(pm.unet).items()} for _ in range(2)]
    return dict(port=pm, jax=jm, trees=trees)


@pytest.fixture
def same_latents(monkeypatch):
    """Both packages start the denoise from one numpy draw."""
    draw = np.random.default_rng(1).standard_normal((1, 8, 8, 4)).astype(np.float32)
    monkeypatch.setattr(jax_infer.diff, "get_initial_latents",
                        lambda key, state, n, h, w: draw * state.init_noise_sigma)
    monkeypatch.setattr(diff, "get_initial_latents",
                        lambda gen, state, n, h, w, device: torch.from_numpy(
                            draw.transpose(0, 3, 1, 2)).to(device) * state.init_noise_sigma)


@pytest.mark.parametrize("form", ["none", "-1", "+1", "list"])
def test_generate_latents_matches_jax(models, same_latents, form):
    pm, jm, (a, b) = models["port"], models["jax"], models["trees"]
    kw = {}
    if form == "list":
        port_lora, jax_lora_arg = [(a, 0.5), (b, -1.0)], [(to_flax(a), 0.5), (to_flax(b), -1.0)]
        kw = dict(spec=lora.LoRASpec(**SPEC))
        jkw = dict(spec=jax_lora.LoRASpec(**SPEC))
    elif form == "none":
        port_lora = jax_lora_arg = None
        jkw = {}
    else:
        port_lora, jax_lora_arg, jkw = a, to_flax(a), {}
        kw = jkw = {"multiplier": float(form)}
    want = np.asarray(jax_infer.generate_latents(jm, "van gogh", "cat", jax_infer.GenerationConfig(
        **GEN.__dict__), lora=jax_lora_arg, **jkw))
    got = infer.generate_latents(pm, "van gogh", "cat", GEN, lora=port_lora, **kw)
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(got, want, atol=ATOL + RTOL * np.abs(want).max())


def test_encode_matches_jax(models):
    got = infer._encode(models["port"], "van gogh")
    want = jax_infer._encode(models["jax"], "van gogh")
    np.testing.assert_allclose(got.text_embeds.numpy(), np.asarray(want.text_embeds), atol=1e-5)
    np.testing.assert_allclose(got.pooled_embeds.numpy(), np.asarray(want.pooled_embeds),
                               atol=1e-5)


def test_positive_embeds_with_xl_raises(models):
    emb = torch.zeros((1, 77, 32))
    with pytest.raises(ValueError, match="SD1.x/2.x"):
        infer.generate_latents(models["port"], "van gogh", gen=GEN, positive_embeds=emb)
    with pytest.raises(ValueError, match="SD1.x/2.x"):
        jax_infer.generate_latents(models["jax"], "van gogh", gen=jax_infer.GenerationConfig(
            **GEN.__dict__), positive_embeds=emb.numpy())


def test_ab_compare_and_the_list_form_on_xl(models):
    """The grid's multiplier 0 is the model without the LoRA; -1 and +1
    differ from it; the list form [(L, 0.5), (L, 0.5)] is L at 1.0 (fp32:
    the fold against the branch); the model is left as it was."""
    pm, (a, _) = models["port"], models["trees"]
    before = {k: v.detach().clone() for k, v in lora.lora_parameters(pm.unet).items()}
    grid = infer.ab_compare(pm, a, "van gogh", gen=GEN)
    plain = infer.generate_latents(pm, "van gogh", gen=GEN)
    assert set(grid) == {-1.0, 0.0, 1.0}
    assert torch.equal(grid[0.0], plain)
    assert not torch.allclose(grid[1.0], plain) and not torch.allclose(grid[-1.0], plain)
    listed = infer.generate_latents(pm, "van gogh", gen=GEN, lora=[(a, 0.5), (a, 0.5)],
                                    spec=lora.LoRASpec(**SPEC))
    torch.testing.assert_close(listed, grid[1.0], rtol=0,
                               atol=1e-4 * grid[1.0].abs().max().item())
    for k, v in lora.lora_parameters(pm.unet).items():
        assert torch.equal(v, before[k]), k


def test_decode_at_the_sdxl_scaling_factor(models, ckpt):
    vae = loader.load_vae_decoder(str(ckpt), device="cpu")
    assert vae.config.scaling_factor == 0.13025
    images = infer.decode_latents(models["port"], infer.generate_latents(
        models["port"], "van gogh", gen=GEN), vae)
    assert images.shape == (1, 64, 64, 3) and images.dtype == np.uint8


def test_infer_xl_script_writes_pngs(ckpt, tmp_path, monkeypatch):
    """`python -m leco_tpu_torch.scripts.infer_xl <dir> --device cpu`: the
    reference's smoke script (DDIM, guidance 7, noise offset 0.0357) at a
    CPU size, one PNG per image in the working directory."""
    assert (infer_xl.DDIM_STEPS, infer_xl.HEIGHT, infer_xl.WIDTH, infer_xl.SDXL_NOISE_OFFSET) \
        == (16, 1024, 768, 0.0357)
    monkeypatch.setattr(infer_xl, "HEIGHT", 64)
    monkeypatch.setattr(infer_xl, "WIDTH", 96)
    monkeypatch.setattr(infer_xl, "DDIM_STEPS", 2)
    monkeypatch.chdir(tmp_path)
    paths = infer_xl.main([str(ckpt), "--device", "cpu"])
    assert paths == ["output_0.png"]
    data = (tmp_path / "output_0.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(data[16:20], "big") == 96 and int.from_bytes(data[20:24], "big") == 64


def test_infer_xl_script_refuses_cuda_without_a_gpu(ckpt):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_xl.main([str(ckpt)])
