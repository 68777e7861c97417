"""The port's sharded train step against the JAX package's unsharded one.

Each mesh runs one step of `leco_tpu_torch.train.trainer.make_train_step` on
2 or 4 gloo ranks (`leco_tpu_torch.parallel.testing`, one spawn per world
size) from the same weights, prompt embeddings and latents as one step of
`jax_trainer.make_train_step(mesh=None)`: GSPMD's semantics, under which a
sharded step computes what the unsharded step computes, are the oracle. The
weights are a random tiny UNet (every lora_up drawn, so that every LoRA leaf
has a gradient) carried to the JAX package through `port_to_flax`; at 128 px
level 0 has 256 tokens, so the flash route runs (the kernels' plain versions
on the CPU) and, under sp 2, decides on the global 256 tokens, not the
rank's 128. The meshes: dp 2 at batch 2 (the batch sharded) and at batch 1
(the CFG 2B sharded, the 3B references and the target replicated), sp 2 at
batch 1 (with and without checkpoint_unet), dp x sp 2 x 2 at batch 1, tp 2,
tp 2 on the tiny SDXL UNet, and sp 2 at 144 px, whose level-1 H of 9 rows
does not divide sp, so the step runs with H replicated over sp.

Tolerances are `tests/test_torch_port_train_step.py`'s: rtol 1e-4 on the
loss, 1e-4 x max|g| on each LoRA gradient (fp32; the sharded sums run in
other orders). Every rank ends the step with bitwise the same LoRA.

Then `seed: null` gives every rank one schedule and one latent draw, an
sp 2 run stopped and resumed is bitwise the uninterrupted one (rank 1, with
a save path of its own, resumes from rank 0's snapshot), and
`python -m leco_tpu_torch.train_lora --device cpu` on 2 ranks set by the
environment (sp 2, 2 iterations): rank 0 alone writes, and its losses and
save match the single-process CLI's (the save at 2e-4 x max|w|: AdamW's
m / sqrt(v) doubles a gradient's relative error).
"""

import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from leco_tpu import lora as jax_lora
from leco_tpu.models.unet import UNet2DConditionModel as JaxUNet
from leco_tpu.models.unet import UNetConfig as JaxUNetConfig
from leco_tpu.ops.schedulers import NoiseScheduler as JaxNoiseScheduler
from leco_tpu.prompts import PromptSettings as JaxPromptSettings
from leco_tpu.testing import _fake_encode_fn as jax_fake_encode_fn
from leco_tpu.train import diffusion as jax_diff
from leco_tpu.train import optim as jax_optim
from leco_tpu.train import trainer as jax_trainer
from leco_tpu_torch import lora
from leco_tpu_torch.lora import read_safetensors
from leco_tpu_torch.models.unet import UNet2DConditionModel, tiny_unet_config
from leco_tpu_torch.parallel import testing as ptesting
from leco_tpu_torch.prompts import PromptEmbedsPair, PromptEmbedsXL, PromptSettings
from leco_tpu_torch.testing import init_unet_, tiny_xl_unet_config, xl_pooled_dim
from leco_tpu_torch.train import trainer
from leco_tpu_torch.train_lora import main, parse_args
from tests.test_torch_port_cli import checkpoint, write_run  # noqa: F401 (fixture)
from tests.test_torch_port_train_step import _flax_layout, _port_name
from tests.test_torch_port_unet import port_to_flax

REPO = Path(__file__).resolve().parents[1]
LR, MAX_STEPS, TIMESTEPS_TO = 1e-4, 4, 2
PROMPT = dict(target="van gogh", positive="van gogh, oil", guidance_scale=2.0)
# name: (UNet config, batch, resolution)
CASES = {
    "sd_b1": (tiny_unet_config(), 1, 128),
    "sd_b2": (tiny_unet_config(), 2, 128),
    "sd_b1_144": (tiny_unet_config(), 1, 144),  # latent 18: level 1 holds 9 rows
    # the tiny SDXL layout, one layer a block and one transformer a layer
    # (which keeps the JAX step's compile short); level 1 at 16 x 16
    "xl_b1": (dataclasses.replace(tiny_xl_unet_config(depth=1), layers_per_block=1,
                                  transformer_layers_per_block=(1, 1, 1)), 1, 256),
}
# name: (case, (inner axis, size), extra) on 2 ranks, and on 4
TWO_RANKS = {
    "dp2_b2": ("sd_b2", ("tp", 1), {}),
    "dp2_b1": ("sd_b1", ("tp", 1), {}),
    "sp2_b1": ("sd_b1", ("sp", 2), {}),
    "sp2_b1_checkpoint_unet": ("sd_b1", ("sp", 2), {"checkpoint_unet": True}),
    "tp2_b1": ("sd_b1", ("tp", 2), {}),
    "tp2_xl_b1": ("xl_b1", ("tp", 2), {}),
    "sp2_b1_h_indivisible": ("sd_b1_144", ("sp", 2), {}),
}
FOUR_RANKS = {"dp2_sp2_b1": ("sd_b1", ("sp", 2), {})}
STEPS = {**{k: (2, v) for k, v in TWO_RANKS.items()}, **{k: (4, v) for k, v in FOUR_RANKS.items()}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(config, batch: int, res: int, seed: int = 0):
    """A random port UNet and the JAX package's bundle, pack and key on the
    same weights -> (the case the ranks run, the JAX step's arguments)."""
    port = UNet2DConditionModel(config, attn_backend="flash")
    gen = torch.Generator().manual_seed(seed)
    init_unet_(port, gen, torch.float32)
    lora.apply_lora_spec(port, lora.LoRASpec(rank=4, alpha=1.0), gen)
    ptesting.perturb_lora_(port, seed, scale=0.05)
    state = {k: v.detach().clone() for k, v in port.state_dict().items()}
    base, lora_tree = jax_lora.split_lora_params(
        port_to_flax({k: v.numpy() for k, v in state.items()}))
    spec = jax_lora.LoRASpec(4, 1.0)
    is_xl = port.is_xl
    jb = jax_trainer.ModelBundle(
        unet=JaxUNet(config=JaxUNetConfig(**{f: getattr(config, f)
                                             for f in config.__dataclass_fields__}),
                     lora_spec=spec),
        base_params=jax.tree.map(jnp.asarray, base),
        lora_params=jax.tree.map(jnp.asarray, lora_tree), scheduler=JaxNoiseScheduler("ddim"),
        spec=spec, encode_fn=jax_fake_encode_fn(config.cross_attention_dim, is_xl,
                                                xl_pooled_dim(config) if is_xl else 1280),
        is_xl=is_xl)
    settings = dict(PROMPT, resolution=res, batch_size=batch)
    (pair,) = jax_trainer.encode_prompt_pairs([JaxPromptSettings(**settings)], jb.encode_fn,
                                              is_xl)
    key = jax.random.PRNGKey(7)
    latents = np.asarray(jax_diff.get_random_noise(jax.random.split(key)[0], batch, res, res))

    def embeds(e):
        if is_xl:
            return PromptEmbedsXL(torch.tensor(np.asarray(e.text_embeds)),
                                  torch.tensor(np.asarray(e.pooled_embeds)))
        return torch.tensor(np.asarray(e))

    ppair = PromptEmbedsPair(*(embeds(e) for e in (pair.target, pair.positive,
                                                   pair.unconditional, pair.neutral)),
                             PromptSettings.from_dict(settings))
    case = {"config": config, "state": state, "res": res, "max_steps": MAX_STEPS,
            "timesteps_to": TIMESTEPS_TO, "guidance_scale": ppair.guidance_scale,
            "erase_sign": ppair.erase_sign,
            "pack": trainer.build_pack(ppair, is_xl, res, res),
            "latents": torch.tensor(latents.transpose(0, 3, 1, 2))}
    return case, (jb, pair, key, res)


def _jax_step(jb, pair, key, res) -> dict:
    """One unsharded JAX step -> its loss and LoRA gradients (AdamW's first
    moment / 0.1) in the port's names."""
    optimizer = jax_optim.get_optimizer("adamw", jax_optim.get_lr_schedule("constant", LR, 10))
    lora_in = jax.tree.map(jnp.array, jb.lora_params)
    opt_state = optimizer.init(lora_in)
    step = jax_trainer.make_train_step(jb, optimizer, MAX_STEPS)
    _, opt_state, loss = step(
        jb.base_params, lora_in, opt_state, key,
        jax_trainer.build_pack(pair, jb.is_xl, res, res),
        jnp.float32(pair.guidance_scale), jnp.float32(pair.erase_sign),
        jnp.int32(TIMESTEPS_TO), height=res, width=res, shard_batch=False)
    return {"loss": float(loss), "grads": {_port_name(k): np.asarray(v) / 0.1
                                           for k, v in flatten_dict(opt_state[0].mu).items()}}


def _job(cases: dict, steps: dict) -> dict:
    names = {entry[0] for entry in steps.values()}
    return {"kind": "steps", "lr": LR, "cases": {n: cases[n] for n in names},
            "steps": {k: {"case": c, "mesh": mesh, **extra}
                      for k, (c, mesh, extra) in steps.items()}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' steps, the JAX package's unsharded steps (compiled while
    the ranks run) and the port's own unsharded steps -> {"ranks": {step:
    [each rank's result]}, "jax": {case: ...}, "unsharded": {case: ...}}."""
    built = {name: _case(*spec) for name, spec in CASES.items()}
    cases = {name: case for name, (case, _) in built.items()}
    running = {world: ptesting.Running(_job(cases, steps), world,
                                       tmp_path_factory.mktemp(f"world{world}"))
               for world, steps in ((2, TWO_RANKS), (4, FOUR_RANKS))}
    with concurrent.futures.ThreadPoolExecutor(len(built)) as pool:  # XLA compiles in parallel
        futures = {name: pool.submit(_jax_step, *args) for name, (_, args) in built.items()}
        jax_steps = {name: f.result() for name, f in futures.items()}
    unsharded = {}
    for name, case in cases.items():
        unet, spec = ptesting.build_unet(case, torch.device("cpu"))
        unsharded[name] = ptesting.step_once(unet, spec, case, torch.device("cpu"), LR)
    ranks = {}
    for world, handle in running.items():
        results = handle.results()
        for name in (TWO_RANKS if world == 2 else FOUR_RANKS):
            ranks[name] = [r[name] for r in results]
        ranks[f"foreign_modules_{world}"] = [r["foreign_modules"] for r in results]
    return {"ranks": ranks, "jax": jax_steps, "unsharded": unsharded}


@pytest.fixture(scope="module")
def ranks(run):
    return run["ranks"]


def test_rank_processes_import_neither_jax_nor_the_tests(ranks):
    assert ranks["foreign_modules_2"] == [[], []]
    assert ranks["foreign_modules_4"] == [[]] * 4


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_loss_matches_jax(name, ranks, run):
    want = run["jax"][STEPS[name][1][0]]["loss"]
    for r, result in enumerate(ranks[name]):
        assert np.isfinite(result["loss"])
        np.testing.assert_allclose(result["loss"], want, rtol=1e-4, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_gradients_match_jax(name, ranks, run):
    want = run["jax"][STEPS[name][1][0]]["grads"]
    nonzero = 0
    for r, result in enumerate(ranks[name]):
        assert set(result["grads"]) == set(want)
        for leaf, g in want.items():
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(_flax_layout(leaf, result["grads"][leaf]), g,
                                       atol=1e-4 * scale, err_msg=f"{leaf} on rank {r}")
            nonzero += bool(np.abs(g).max() > 0)
    assert nonzero == len(want) * len(ranks[name])  # every leaf, lora_down included


@pytest.mark.parametrize("name", list(STEPS))
def test_every_rank_ends_with_bitwise_the_same_lora(name, ranks):
    first = ranks[name][0]
    for result in ranks[name][1:]:
        for leaf, v in first["lora"].items():
            assert torch.equal(result["lora"][leaf], v), leaf
        assert result["loss"] == first["loss"]


@pytest.mark.parametrize("name", list(STEPS))
def test_every_rank_takes_the_unsharded_flash_route(name, ranks, run):
    """Under sp the dispatch decides on the global token counts, so each
    rank runs the kernels' route as often as the unsharded step."""
    want = {k: v for k, v in run["unsharded"][STEPS[name][1][0]]["calls"].items()
            if k in ptesting.FLASH_PLAIN}
    assert want["attn_fwd_plain"] > 0 and want["attn_bwd_dkv_plain"] > 0
    if STEPS[name][1][2].get("checkpoint_unet"):  # the target's forward runs again
        want["attn_fwd_plain"] += want["attn_fwd_plain"] // (TIMESTEPS_TO + 2)
    for result in ranks[name]:
        assert {k: result["calls"][k] for k in want} == want


def test_the_meshes_shard_what_they_name(ranks):
    assert [r["coords"] for r in ranks["dp2_sp2_b1"]] == [
        {"dp": 0, "sp": 0}, {"dp": 0, "sp": 1}, {"dp": 1, "sp": 0}, {"dp": 1, "sp": 1}]
    for name in ("tp2_b1", "tp2_xl_b1"):
        assert all(r["tp_layers"] > 0 for r in ranks[name]), name
    assert all(r["tp_layers"] == 0 for r in ranks["dp2_b1"])


def test_seed_null_gives_every_rank_one_schedule_and_latents(tmp_path):
    a, b = ptesting.spawn({"kind": "seed"}, 2, tmp_path)
    assert a["seed"] is not None and a["seed"] == b["seed"]
    assert a["schedule"] == b["schedule"]
    assert torch.equal(a["latents"], b["latents"])
    assert a["foreign_modules"] == b["foreign_modules"] == []


def test_a_resumed_sharded_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """sp 2: 4 iterations against 2 + resume 2. Each rank saves under a
    directory of its own, so rank 1 sees no snapshot and resumes from rank
    0's (ddpm draws noise every step: the generator comes back too)."""
    ranks = ptesting.spawn({"kind": "resume", "workdir": str(tmp_path)}, 2, tmp_path / "job")
    assert [r["snapshot_seen"] for r in ranks] == [1, None]
    for r, result in enumerate(ranks):
        assert result["foreign_modules"] == []
        assert result["resumed"]["losses"] == result["whole"]["losses"][2:], r
        for k, v in result["whole"]["lora"].items():
            assert torch.equal(result["resumed"]["lora"][k], v), (k, r)
            assert torch.equal(ranks[0]["resumed"]["lora"][k], v), (k, r)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_on_two_ranks_writes_once_and_matches_one_process(checkpoint, tmp_path):  # noqa: F811
    """sp 2 over 2 CPU ranks set by the environment: rank 0 alone prints and
    writes; its save is the single-process CLI's within the step tolerance."""
    _two_rank_cli(checkpoint, tmp_path)


def test_cli_on_two_ranks_with_the_knobs_matches_one_process(checkpoint, tmp_path,  # noqa: F811
                                                             monkeypatch):
    """The same with the four fused knobs set for both runs: the tiny UNet's
    GroupNorms and GEGLUs take the kernels' routes (its convs stay under
    the gates' 128-channel floors), on each rank's rows. AdamW with eps 1,
    far above every gradient, so that each update is near linear in the
    gradients and the save carries their bound: at eps 1e-8 a near-zero
    gradient (a sum whose ranks' partials round apart, as the GroupNorm
    kernel's E[x²] − mean² over two ranks' sums does) moves its weight by
    lr·g / (|g| + eps), whose slope lr / eps makes its rounding a large
    share of lr."""
    knobs = {"LECO_CONV_BACKEND": "gemm", "LECO_RESNET_FUSED": "1", "LECO_TPU_FUSED_GN": "1",
             "LECO_GEGLU": "fused"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    _two_rank_cli(checkpoint, tmp_path, '\n  optimizer_args: "eps=1.0"')


def _two_rank_cli(checkpoint, tmp_path, extra_train: str = ""):  # noqa: F811
    """The CLI on one process, then on 2 ranks at sp 2, with `extra_train`
    in both configs' `train:` and the environment as it is; rank 0 alone
    prints and writes, and its losses and save are the single process's."""
    one = tmp_path / "one"
    one.mkdir()
    main(parse_args(["--config_file", str(write_run(one, checkpoint, extra_train)),
                     "--device", "cpu"]))
    two = tmp_path / "two"
    two.mkdir()
    config = write_run(two, checkpoint, extra_train + "\n  spatial_parallel: 2")
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "leco_tpu_torch.train_lora", "--config_file", str(config),
             "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert "Loss*1k" in outs[0][0] and "Done." in outs[0][0]
    assert outs[1][0].strip() == ""  # rank 1 prints nothing
    records = (two / "out" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(r)["iteration"] for r in records] == [0, 1]  # written once
    got, _ = read_safetensors(two / "out" / "tiny_cli_last.safetensors")
    want, _ = read_safetensors(one / "out" / "tiny_cli_last.safetensors")
    assert set(got) == set(want)
    # the step's 1e-4 on the gradients becomes 2e-4 on AdamW's updates: the
    # ratio m / sqrt(v) takes a gradient's relative error twice
    for k, v in want.items():
        scale = max(float(v.abs().max()), 1e-12)
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-4 * scale, err_msg=k)
    one_losses = [json.loads(r)["loss"] for r in
                  (one / "out" / "metrics.jsonl").read_text().splitlines()]
    np.testing.assert_allclose([json.loads(r)["loss"] for r in records], one_losses, rtol=1e-4)
