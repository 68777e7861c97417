"""The port's UNet against diffusers golden activations: the counterpart of
tests/test_unet_goldens.py.

A fixture is one `.npz` in tests/fixtures/unet_goldens/, in the format
`scripts/gen_unet_goldens.py` writes on a machine with diffusers (which
neither this repository's test machine nor the card's has): `__config__`
(the diffusers constructor kwargs as JSON), `sd:<torch key>` (every
state-dict tensor, fp32), `sample`, `timestep`, `encoder_hidden_states`,
`text_embeds` / `time_ids` (text_time only) and `output`, all NCHW. Here
`_run_fixture` reads one into the port's UNet through the loader's own
path (`loader.build_unet`: every key and shape checked) and runs it in
fp32, held to the golden at the JAX test's tolerance.

No golden is present yet, so the parametrised case collects nothing; the
round trips below write fixtures from the JAX package's tiny UNets (SD and
SDXL layouts) through the JAX test's `_flax_to_torch_layout` and hold the
port to them, which exercises the format and this harness on every run.
"""

import glob
import importlib.util
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu_torch.models.loader import build_unet
from leco_tpu_torch.models.unet import UNet2DConditionModel, UNetConfig

REPO = Path(__file__).resolve().parents[1]
FIXTURE_DIR = REPO / "tests" / "fixtures" / "unet_goldens"
FIXTURES = sorted(glob.glob(str(FIXTURE_DIR / "*.npz")))
# the JAX test's fp32 tolerance against diffusers (tests/test_unet_goldens.py)
RTOL, ATOL = 1e-3, 2e-4

# diffusers constructor kwargs whose JSON lists are tuples in UNetConfig
_TUPLE_FIELDS = {"down_block_types", "up_block_types", "block_out_channels",
                 "transformer_layers_per_block", "attention_head_dim"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_goldens_module():
    """tests/test_unet_goldens.py by path (its `pytestmark = slow` keeps its
    own cases out of this run; only its helpers are used)."""
    spec = importlib.util.spec_from_file_location(
        "jax_unet_goldens", REPO / "tests" / "test_unet_goldens.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_from_diffusers_kwargs(cfg: dict) -> UNetConfig:
    """The JAX test's rule on the port's UNetConfig: the names coincide, a
    key UNetConfig lacks is refused."""
    known = set(UNetConfig.__dataclass_fields__)
    kwargs = {}
    for k, v in cfg.items():
        if k not in known:
            raise ValueError(f"fixture config key {k!r} not in UNetConfig")
        kwargs[k] = tuple(v) if k in _TUPLE_FIELDS and isinstance(v, list) else v
    return UNetConfig(**kwargs)


def _fold(key: str) -> str:
    """A torch key with each numeric segment joined to the one before it,
    "linear.1.weight" and "linear_1.weight" alike (the JAX converter's
    `_fold_path` rule, under which both layouts name one leaf)."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", key)


def port_state(cfg: UNetConfig, sd: dict) -> dict:
    """A fixture's state dict under the port's own keys: diffusers' keys
    are the port's; the JAX test's inverse converter writes `linear_1` as
    `linear.1`, which `_fold` maps to the same key. A key that maps to
    none stays as it is, for `build_unet` to refuse."""
    with torch.device("meta"):
        names = {_fold(k): k for k in UNet2DConditionModel(cfg).state_dict()}
    return {names.get(_fold(k), k): v for k, v in sd.items()}


def _run_fixture(data: dict) -> tuple[np.ndarray, np.ndarray]:
    """(the port's output, the golden output), both NCHW fp32."""
    cfg = config_from_diffusers_kwargs(json.loads(str(data["__config__"])))
    sd = {k[len("sd:"):]: torch.from_numpy(np.asarray(v)) for k, v in data.items()
          if k.startswith("sd:")}
    unet = build_unet(cfg, port_state(cfg, sd), None, torch.float32, "xla", "cpu")
    added = None
    if cfg.addition_embed_type == "text_time":
        added = {k: torch.from_numpy(np.asarray(data[k])) for k in ("text_embeds", "time_ids")}
    with torch.no_grad():
        out = unet(torch.from_numpy(np.asarray(data["sample"])),
                   torch.from_numpy(np.asarray(data["timestep"], np.float32)),
                   torch.from_numpy(np.asarray(data["encoder_hidden_states"])), added)
    return out.numpy(), np.asarray(data["output"])


def load_fixture(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("path", FIXTURES, ids=[os.path.basename(p) for p in FIXTURES])
def test_unet_matches_diffusers_golden(path):
    got, want = _run_fixture(load_fixture(path))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


SD_KWARGS = dict(
    sample_size=8,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    block_out_channels=(8, 16),
    layers_per_block=1,
    cross_attention_dim=32,
    attention_head_dim=2,
    norm_num_groups=4,
)
# SDXL's layout at the widths of gen_unet_goldens.py's sdxl_small, narrowed
XL_KWARGS = dict(
    sample_size=8,
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    block_out_channels=(8, 16),
    layers_per_block=2,
    transformer_layers_per_block=(1, 2),
    cross_attention_dim=32,
    attention_head_dim=(2, 4),
    use_linear_projection=True,
    addition_embed_type="text_time",
    addition_time_embed_dim=4,
    projection_class_embeddings_input_dim=4 * 6 + 8,
    norm_num_groups=4,
)


def write_jax_fixture(path: Path, cfg_kwargs: dict) -> None:
    """A golden from the JAX package's UNet: random init, one fp32 forward
    at t 417, the weights in the torch layout of the JAX test's inverse
    converter, in gen_unet_goldens.py's format."""
    goldens = jax_goldens_module()
    cfg = JaxUNetConfig(**cfg_kwargs)
    unet = JaxUNet(config=cfg)
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ehs = rng.standard_normal((2, 77, cfg.cross_attention_dim)).astype(np.float32)
    t = np.float32(417.0)
    added, arrays = None, {}
    if cfg.addition_embed_type == "text_time":
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        arrays["text_embeds"] = rng.standard_normal((2, pooled)).astype(np.float32)
        arrays["time_ids"] = np.tile(np.array([[512, 512, 0, 0, 512, 512]], np.float32), (2, 1))
        added = {k: jnp.asarray(arrays[k]) for k in ("text_embeds", "time_ids")}
    params = unet.init(jax.random.PRNGKey(2), jnp.asarray(sample), t, jnp.asarray(ehs),
                       added)["params"]
    # off the init (LayerNorm and GroupNorm at 1/0, zero biases) so that a
    # swapped or dropped affine shows
    params = jax.tree.map(
        lambda v: v + 0.05 * jnp.asarray(rng.standard_normal(v.shape), v.dtype), params)
    want = unet.apply({"params": params}, jnp.asarray(sample), t, jnp.asarray(ehs), added)
    arrays.update({f"sd:{k}": v for k, v in goldens._flax_to_torch_layout(params).items()})
    arrays.update(
        __config__=np.str_(json.dumps(cfg_kwargs)),
        __meta__=np.str_(json.dumps({"self_test": True})),
        sample=sample.transpose(0, 3, 1, 2),
        timestep=np.asarray(t),
        encoder_hidden_states=ehs,
        output=np.asarray(want).transpose(0, 3, 1, 2),
    )
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("cfg_kwargs", [SD_KWARGS, XL_KWARGS], ids=["sd", "sdxl"])
def test_roundtrip_through_harness(tmp_path, cfg_kwargs):
    """The golden format through the port's harness: a fixture written
    from the JAX package's UNet, read into the port's."""
    path = tmp_path / "self_test.npz"
    write_jax_fixture(path, cfg_kwargs)
    data = load_fixture(path)
    got, golden = _run_fixture(data)
    assert got.shape == golden.shape == data["sample"].shape
    np.testing.assert_allclose(got, golden, rtol=RTOL, atol=ATOL)


def test_harness_refuses_a_key_the_config_lacks():
    with pytest.raises(ValueError, match="'act_fn' not in UNetConfig"):
        config_from_diffusers_kwargs({**SD_KWARGS, "act_fn": "silu"})
    got = config_from_diffusers_kwargs(json.loads(json.dumps(XL_KWARGS)))
    assert got == UNetConfig(**XL_KWARGS)
