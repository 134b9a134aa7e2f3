"""The port's training hint sampler and learning-rate schedule against the
JAX package's on the CPU; JAX's random draws are fed to the port's
deterministic cores, and the torch-generator sampler is held
statistically."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ideepcolor_tpu.train import hints_sim as jhs
from ideepcolor_tpu.train import step as jstep
from ideepcolor_tpu_torch.train import hints_sim as ths
from ideepcolor_tpu_torch.train import step as tstep

torch.set_num_threads(2)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _jax_draws(key, n, p_full):
    k_alive, k_loc, k_size, k_full = jax.random.split(key, 4)
    return (np.asarray(jax.random.uniform(k_alive, (n, jhs.MAX_POINTS))),
            np.asarray(jax.random.normal(k_loc, (n, jhs.MAX_POINTS, 2))),
            np.asarray(jax.random.randint(k_size, (n, jhs.MAX_POINTS), 0, 5)),
            np.asarray(jax.random.bernoulli(k_full, p_full, (n, 1, 1, 1))))


@pytest.mark.parametrize("p_keep,p_full,seed",
                         [(1 / 8, 0.01, 0), (0.02, 0.5, 1), (0.5, 0.0, 2)])
def test_sample_hints_core_matches_jax_on_its_draws(p_keep, p_full, seed):
    """On JAX's draws: the masks equal, the ab within 1e-5 (patch means
    summed in another order)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-80, 80, (3, 40, 36, 2)).astype(np.float32)
    key = jax.random.key(seed + 10)
    ja, jm = jhs.sample_hints(key, jnp.asarray(gt), p_keep=p_keep,
                              p_full=p_full)
    coins, normals, half, full = _jax_draws(key, 3, p_full)
    ta, tm = ths.hints_from_draws(
        nchw(gt), torch.from_numpy(coins), torch.from_numpy(normals),
        torch.from_numpy(half),
        torch.from_numpy(full.reshape(3)) if p_full > 0 else None, p_keep)
    assert np.array_equal(nhwc(tm), np.asarray(jm))
    assert np.abs(nhwc(ta) - np.asarray(ja)).max() <= 1e-5
    loc = ths.locations_from_normals(torch.from_numpy(normals), 40, 36)
    jloc = jhs._gaussian_locations(jax.random.split(key, 4)[1], 3, 40, 36)
    assert np.array_equal(loc.numpy(), np.asarray(jloc))


@pytest.mark.parametrize("count", [0, 1, 5, 32])
def test_reveal_fixed_matches_jax(count):
    rng = np.random.default_rng(count)
    gt = rng.uniform(-80, 80, (2, 33, 47, 2)).astype(np.float32)
    key = jax.random.key(count)
    ja, jm = jhs.reveal_hints_fixed(key, jnp.asarray(gt), count, half=3)
    normals = np.asarray(jax.random.normal(key, (2, jhs.MAX_POINTS, 2)))
    ta, tm = ths.reveal_fixed_from_normals(nchw(gt),
                                           torch.from_numpy(normals), count,
                                           half=3)
    assert np.array_equal(nhwc(tm), np.asarray(jm))
    assert np.abs(nhwc(ta) - np.asarray(ja)).max() <= 1e-5


@pytest.mark.parametrize("half", [-1, 5])
def test_reveal_fixed_refuses_half_outside_the_window(half):
    gt = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="half"):
        ths.reveal_hints_fixed(gt, torch.Generator().manual_seed(0), 3, half)
    with pytest.raises(ValueError):
        jhs.reveal_hints_fixed(jax.random.key(0), jnp.zeros((1, 16, 16, 2)),
                               3, half=half)


def test_global_hints_match_jax_on_its_keep_flags():
    rng = np.random.default_rng(5)
    gt = rng.uniform(-60, 60, (4, 16, 16, 2)).astype(np.float32)
    key = jax.random.key(8)
    want = np.asarray(jhs.sample_global_hints(key, jnp.asarray(gt)))
    keep = np.asarray(jax.random.bernoulli(key, 0.5, (4, 1)))[:, 0]
    got = ths.global_hints_from_keep(nchw(gt), torch.from_numpy(keep))
    assert got.shape == (4, 314)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    g = ths.sample_global_hints(nchw(gt), torch.Generator().manual_seed(1))
    assert set(np.unique(g[:, -1].numpy())) <= {0.0, 1.0}


def test_torch_sampler_statistics():
    """The generator-driven sampler: P(0 hints) = p_keep, mean live count
    (1 - p_keep) / p_keep capped at 32, full-reveal rate p_full; 4000
    samples, bounds at about 4 standard errors."""
    n, p_keep, p_full = 4000, 1 / 8, 0.05
    gen = torch.Generator().manual_seed(0)
    coins = torch.rand((n, ths.MAX_POINTS), generator=gen)
    alive = torch.cumprod((coins > p_keep).int(), 1)
    count = alive.sum(1).double()
    assert abs(float((count == 0).double().mean()) - p_keep) < 0.021
    want_mean = sum((1 - p_keep) ** k for k in range(1, 33))
    assert abs(float(count.mean()) - want_mean) < 0.45
    # a full reveal is the ground truth itself; patch means of random
    # pixels never are
    gt = torch.rand((n, 2, 16, 16), generator=torch.Generator().manual_seed(
        2)) * 100
    gen = torch.Generator().manual_seed(1)
    ab, mask = ths.sample_hints(gt, gen, p_keep=p_keep, p_full=p_full)
    full = ((mask == 1).all(3).all(2).all(1)
            & (ab == gt).all(3).all(2).all(1)).double().mean()
    assert abs(float(full) - p_full) < 0.015
    # the draws the sampler makes are the core's: same generator, same hints
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    a = ths.sample_hints(gt[:3], g1)
    b = ths.hints_from_draws(gt[:3], torch.rand((3, 32), generator=g2),
                             torch.randn((3, 32, 2), generator=g2),
                             torch.randint(0, 5, (3, 32), generator=g2),
                             torch.rand((3,), generator=g2) < 0.01)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


SCHEDULES = [dict(schedule="constant"),
             dict(schedule="constant", warmup_steps=10),
             dict(schedule="cosine", warmup_steps=10, total_steps=50),
             dict(schedule="cosine", warmup_steps=0, total_steps=37)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_lr_equals_optax_schedule_at_every_step(kw):
    """The lr of update k is optax's schedule at count k (the count before
    the update: a warm-up's first update has lr 0), for 50 updates: equal
    to the f32 value, except in the cosine decay, where XLA's f32 ``cos``
    and the correctly rounded one differ in the last bit on about 1% of
    the arguments and ``0.5 * (1 + cos)`` cancels: there within 1e-5
    relative (measured: 3 of 100 cosine steps not equal, at most 1.6e-7
    relative). With a gradient of one, Adam moves a weight by the lr (times
    1 / (1 + eps)) in both packages, which shows each optimizer used it."""
    jcfg = jstep.TrainConfig(lr=3e-3, **kw)
    tcfg = tstep.TrainConfig(lr=3e-3, **kw)
    sched = _optax_schedule(jcfg)
    opt = jstep.make_optimizer(jcfg)
    params = {"w": jnp.zeros(())}
    st = opt.init(params)
    p = {"w": torch.zeros((), requires_grad=True)}
    state = {"params": p, "opt": tstep.make_optimizer(tcfg, p), "step": 0}
    for k in range(50):
        want = float(np.float32(sched(jnp.int32(k))))
        got = tstep.lr_at(tcfg, k)
        if kw["schedule"] == "cosine" and k >= max(kw["warmup_steps"], 1):
            assert abs(got - want) <= 1e-5 * want, (k, got, want)
        else:
            assert got == want, (k, got, want)
        upd, st = opt.update({"w": jnp.ones(())}, st, params)
        before = float(p["w"])
        tstep.apply_update(state, tcfg, lambda: (p["w"] * 1.0,
                                                 {"loss": p["w"]}))
        assert state["opt"].param_groups[0]["lr"] == got
        assert np.isclose(-float(upd["w"]), got, rtol=1e-5, atol=0)
        # the weight is f32 near 0.1: its own rounding is about 1e-8
        assert np.isclose(before - float(p["w"]), got, rtol=1e-5, atol=2e-8)
    assert state["step"] == 50
    if kw.get("warmup_steps"):
        assert tstep.lr_at(tcfg, 0) == 0.0


def _optax_schedule(cfg):
    if cfg.schedule == "cosine":
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=cfg.lr,
            warmup_steps=max(cfg.warmup_steps, 1),
            decay_steps=cfg.total_steps, end_value=cfg.lr / 100.0)
    if cfg.warmup_steps > 0:
        return optax.linear_schedule(0.0, cfg.lr, cfg.warmup_steps)
    return lambda count: jnp.float32(cfg.lr)


def test_schedule_refusals_match_optax():
    for kw in (dict(schedule="cosine"), dict(schedule="linear"),
               dict(schedule="cosine", warmup_steps=20, total_steps=20)):
        with pytest.raises(ValueError):
            jstep.make_optimizer(jstep.TrainConfig(**kw))
        with pytest.raises(ValueError):
            tstep.lr_at(tstep.TrainConfig(**kw), 0)
