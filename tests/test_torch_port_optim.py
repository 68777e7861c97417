"""The port's LR schedules and optimizers against the JAX package's
(`leco_tpu/train/optim.py`, `dadapt.py`, `quant8.py`, optax).

Schedules: every step of a 1,000-iteration run against `jax.vmap` of the
JAX schedule, which is what its trainer logs. Optimizers: 10 steps on a
LoRA-shaped tree of 4 leaves with one seeded numpy gradient sequence, the
JAX side through `optax.apply_updates` at the schedule's count and the
port's through `step()` at `lr_at(j)`; the weights after every step are
compared. The gradients do not depend on the weights, so the moments of
both sides follow one sequence; only the D-Adaptation family's distance
estimates (sums over all leaves) take another summation order."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leco_tpu.train import optim as jax_optim
from leco_tpu_torch.train import optim
from leco_tpu_torch.train.quant8 import Adam8bit

SHAPES = ((4, 320), (320, 4), (16, 1280), (1280, 16))
STEPS = 10
# weights after each step: float32 on both sides, the same elementwise
# operations in another order (and, for the D-Adaptation family, tree sums in
# another order): a few float32 ulps of a weight of size ~1
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax_cpu():
    jax.config.update("jax_platforms", "cpu")


@pytest.mark.parametrize("name", ["cosine", "cosine_with_restarts", "step", "linear"])
def test_schedule_matches_jax_at_every_step(name, jax_cpu):
    iterations, lr = 1000, 1e-4
    want = np.asarray(jax.vmap(jax_optim.get_lr_schedule(name, lr, iterations, lr / 100))(
        jnp.arange(iterations)))
    lr_at = optim.get_lr_schedule(name, lr, iterations, lr / 100)
    got = np.asarray([lr_at(j) for j in range(iterations)])
    np.testing.assert_allclose(got, want.astype(np.float64), rtol=1e-6, atol=0)
    if name == "cosine_with_restarts":
        # cycles of T0 = 100, 200, 400 start at 100, 300, 700 with lr
        for j in (99, 100, 299, 300, 699, 700):
            np.testing.assert_allclose(lr_at(j), float(want[j]), rtol=1e-6, err_msg=str(j))
        assert [lr_at(j) == np.float32(lr) for j in (99, 100, 299, 300, 699, 700)] == [
            False, True, False, True, False, True]


def test_constant_schedule_and_unknown_name():
    assert optim.get_lr_schedule("constant", 3e-4, 10)(7) == 3e-4
    assert optim.get_lr_schedule(None, 3e-4, 10)(0) == 3e-4
    with pytest.raises(ValueError):
        optim.get_lr_schedule("warmup", 1e-4, 10)


def test_parse_optimizer_args():
    assert optim.parse_optimizer_args("") == {}
    assert optim.parse_optimizer_args("weight_decay=0.1  betas=(0.9,0.99) decouple=True") == {
        "weight_decay": 0.1, "betas": (0.9, 0.99), "decouple": True}
    assert optim.parse_optimizer_args("d_coef='2'") == {"d_coef": "2"}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]


def _grads():
    """A drift plus noise, so that the D-Adaptation family's distance
    estimates grow as they do in training."""
    rng = np.random.default_rng(1234)
    drift = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    return [[d + (0.5 * rng.standard_normal(d.shape)).astype(np.float32) for d in drift]
            for _ in range(STEPS)]


def _jax_trajectory(tx, params, grads):
    """Eager, one XLA computation per operation: under `jax.jit` XLA fuses
    a*b + c into one rounding, which moves the 8-bit moments across a code
    boundary now and then; the port (on the CPU and on the card alike)
    rounds each operation, as eager JAX does."""
    params = [jnp.asarray(p) for p in params]
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        out.append([np.asarray(p) for p in params])
    return out


def _port_trajectory(name, lr, args, params, grads, schedule="cosine", steps=None):
    leaves = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.get_optimizer(name, leaves, lr, args)
    lr_at = optim.get_lr_schedule(schedule, lr, STEPS, lr / 100)
    out = []
    for j, g in enumerate(grads[:steps]):
        for leaf, x in zip(leaves, g):
            leaf.grad = torch.from_numpy(x)
        for group in opt.param_groups:
            group["lr"] = lr_at(j)
        opt.step()
        out.append([leaf.detach().numpy().copy() for leaf in leaves])
    return out, opt, leaves


# (name, lr, optimizer_args): lr 1 for the learning-rate-free ones, whose
# first distance estimate is raised from 1e-6 to 1e-3 so that 10 steps move
# the weights by more than the tolerance
CASES = [
    ("adamw", 1e-2, ""), ("adamw", 1e-2, "weight_decay=0.1"),
    ("adam", 1e-2, ""), ("adam", 1e-2, "betas=(0.8,0.9)"),
    ("lion", 1e-3, ""), ("lion", 1e-3, "weight_decay=0.1"), ("lion", 1e-3, "betas=(0.95,0.98)"),
    ("prodigy", 1.0, "estim_lr0=1e-3"), ("prodigy", 1.0, "estim_lr0=1e-3 weight_decay=0.1"),
    ("dadaptadam", 1.0, "estim_lr0=1e-3"),
    ("dadaptadam", 1.0, "estim_lr0=1e-3 weight_decay=0.1"),
    ("dadaptlion", 1.0, "d0=1e-3"), ("dadaptlion", 1.0, "d0=1e-3 weight_decay=0.1"),
    ("adam8bit", 1e-2, ""), ("adam8bit", 1e-2, "weight_decay=0.1"),
    ("lion8bit", 1e-3, ""), ("lion8bit", 1e-3, "weight_decay=0.1"),
]


@pytest.mark.parametrize("name,lr,args", CASES)
def test_optimizer_matches_jax(name, lr, args, jax_cpu):
    params, grads = _tree(0), _grads()
    tx = jax_optim.get_optimizer(name, jax_optim.get_lr_schedule("cosine", lr, STEPS, lr / 100),
                                 args)
    want = _jax_trajectory(tx, params, grads)
    got, _, _ = _port_trajectory(name, lr, args, params, grads)
    for j, (gs, ws) in enumerate(zip(got, want)):
        for k, (g, w) in enumerate(zip(gs, ws)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"step {j} leaf {k}")
    moved = max(float(np.abs(w - p).max()) for w, p in zip(want[-1], params))
    assert moved > 10 * ATOL  # the weights did move


@pytest.mark.parametrize("name,factory", [("prodigy", optax.contrib.prodigy),
                                          ("dadaptadam", optax.contrib.dadapt_adamw)])
def test_betas_reach_prodigy_and_dadapt_adam(name, factory, jax_cpu):
    """The JAX factory passes betas to these as b1/b2, which optax refuses;
    the port passes them where optax's `betas` goes."""
    schedule = jax_optim.get_lr_schedule("cosine", 1.0, STEPS, 0.01)
    with pytest.raises(TypeError):
        jax_optim.get_optimizer(name, schedule, "betas=(0.8,0.9)")
    params, grads = _tree(3), _grads()
    want = _jax_trajectory(factory(learning_rate=schedule, betas=(0.8, 0.9), estim_lr0=1e-3),
                           params, grads)
    got, opt, _ = _port_trajectory(name, 1.0, "betas=(0.8,0.9) estim_lr0=1e-3", params, grads)
    assert opt.param_groups[0]["betas"] == (0.8, 0.9)
    for g, w in zip(got[-1], want[-1]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,args,error", [
    ("adam", "weight_decay=0.1", TypeError),
    ("lion", "eps=1e-8", TypeError),
    ("dadaptsgd", "", ValueError),
    ("sgd", "", ValueError),
])
def test_what_jax_refuses_the_port_refuses(name, args, error, jax_cpu):
    schedule = jax_optim.get_lr_schedule("constant", 1e-4, 10)
    with pytest.raises(error):
        jax_optim.get_optimizer(name, schedule, args)
    with pytest.raises(error):
        optim.get_optimizer(name, [torch.nn.Parameter(torch.zeros(2))], 1e-4, args)


@pytest.mark.parametrize("name,lr", [("adamw", 1e-2), ("adam", 1e-2), ("lion", 1e-3),
                                     ("prodigy", 1.0), ("dadaptadam", 1.0),
                                     ("dadaptlion", 1.0), ("adam8bit", 1e-2),
                                     ("lion8bit", 1e-3)])
def test_state_dict_resumes_bit_equal(name, lr):
    """5 steps, a state_dict through torch.save, a fresh optimizer on copies
    of the weights: the next 5 steps are bit-equal to the uninterrupted run."""
    params, grads = _tree(5), _grads()
    whole, _, _ = _port_trajectory(name, lr, "", params, grads)
    first, opt, leaves = _port_trajectory(name, lr, "", params, grads, steps=5)
    buf = io.BytesIO()
    torch.save(opt.state_dict(), buf)
    buf.seek(0)
    fresh = [torch.nn.Parameter(leaf.detach().clone()) for leaf in leaves]
    opt2 = optim.get_optimizer(name, fresh, lr)
    opt2.load_state_dict(torch.load(buf, weights_only=True))
    if isinstance(opt2, Adam8bit):
        assert all(st["mu_codes"].dtype == torch.uint8 for st in opt2.state.values())
    lr_at = optim.get_lr_schedule("cosine", lr, STEPS, lr / 100)
    for j in range(5, STEPS):
        for leaf, x in zip(fresh, grads[j]):
            leaf.grad = torch.from_numpy(x)
        opt2.param_groups[0]["lr"] = lr_at(j)
        opt2.step()
    for got, want in zip(fresh, whole[-1]):
        np.testing.assert_array_equal(got.detach().numpy(), want)
