"""PGGAN progressive trainer: fade-in blending property, schedule
progression, and an end-to-end tiny progressive run (the reference keeps
this model family as dead code — ``cifar10/common/resnet_block.py:192-349``;
here it trains)."""

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu.core.module import Ctx, merge
from rcgan_tpu.models.pggan import PGGANConfig, generator
from rcgan_tpu.models.resnet_gan import ResnetGANConfig
from rcgan_tpu.train.pggan_loop import PGGANTrainConfig, PGGANTrainer, pool_to_stage


def tiny():
    cfg = PGGANConfig(z_dim=8, dim=8, max_stage=2)  # 4 -> 8 -> 16
    base = ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12)
    tcfg = PGGANTrainConfig(trans_iters=3, stab_iters=3)
    return cfg, base, tcfg


def test_pool_to_stage_shapes():
    x = jnp.zeros((2, 16, 16, 3))
    assert pool_to_stage(x, PGGANConfig(max_stage=2), 1).shape == (2, 8, 8, 3)
    assert pool_to_stage(x, PGGANConfig(max_stage=2), 2).shape == (2, 16, 16, 3)


def test_fade_in_alpha_zero_equals_upsampled_low_res():
    """At alpha=0 during transition the generator must output exactly the
    upsampled previous-stage RGB (the PGGAN fade-in contract)."""
    cfg, base, _ = tiny()
    tr = PGGANTrainer(cfg, base, PGGANTrainConfig())
    ts = tr.init(jax.random.key(0), 4)

    z = jax.random.normal(jax.random.key(1), (4, cfg.z_dim))
    labels = jnp.zeros((4,), jnp.int32)
    params = merge(*ts.groups.values())

    ctx = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    out_fade = generator(ctx, cfg, base, z, labels, stage=2, trans=True, alpha=0.0)

    ctx2 = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    out_low = generator(ctx2, cfg, base, z, labels, stage=1, trans=False)
    from rcgan_tpu.ops import upsample_depth_to_space

    # stage-1 output goes through ToRGB.1 — the same layer the transition
    # branch blends in, so alpha=0 reproduces its upsampling exactly
    np.testing.assert_allclose(
        np.asarray(out_fade), np.asarray(upsample_depth_to_space(out_low)),
        rtol=1e-5, atol=1e-5,
    )


def test_generator_init_output_unsaturated_at_every_stage():
    """Regression for the stage-3 collapse: without pixel-norm after every
    block the residual sum's variance grows with depth and the fresh
    stage's tanh output saturates at init (|tanh| -> 1.000 measured at
    full size), killing the ToRGB gradient so the new stage never trains.
    With the fix, init-time output magnitude must stay moderate and
    roughly depth-independent."""
    cfg = PGGANConfig(z_dim=128, dim=128, max_stage=3)
    base = ResnetGANConfig(dim_g=128, dim_d=128, z_dim=128)
    tr = PGGANTrainer(cfg, base, PGGANTrainConfig())
    ts = tr.init(jax.random.key(0), 8)
    z = jax.random.normal(jax.random.key(1), (8, cfg.z_dim))
    y = jnp.arange(8, dtype=jnp.int32) % 10
    means = []
    for stage in (1, 2, 3):
        out = np.abs(np.asarray(tr.sample(ts, z, y, stage=stage)))
        means.append(out.mean())
        assert out.mean() < 0.9, (stage, out.mean())
    # depth-independence: deepest stage within 1.5x of the shallowest
    assert max(means) < 1.5 * min(means) + 0.05, means


def test_conditional_projection_head():
    """The conditional critic's projection head must exist and make the
    logit label-dependent; ``conditional=False`` must reproduce the
    label-blind critic (no head params, labels ignored).  Without the head
    the label-conditioned generator has no conditioning signal at all —
    the round-3 unconditional 64x64 run sat at chance accuracy."""
    import dataclasses

    from rcgan_tpu.models.pggan import discriminator

    cfg, base, tcfg = tiny()
    tr = PGGANTrainer(cfg, base, tcfg)
    ts = tr.init(jax.random.key(0), 4)
    head = [k for k in ts.groups["disc"] if k.startswith("PG.D.Embedding")]
    assert head, sorted(ts.groups["disc"])[:8]

    params = merge(*ts.groups.values())
    x = jax.random.normal(jax.random.key(3), (4, 16, 16, 3))
    ctx = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    _, l0 = discriminator(ctx, cfg, base, x, stage=2, labels=jnp.zeros((4,), jnp.int32))
    ctx = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    _, l1 = discriminator(ctx, cfg, base, x, stage=2, labels=jnp.ones((4,), jnp.int32))
    assert not np.allclose(np.asarray(l0), np.asarray(l1))

    cfg_u = dataclasses.replace(cfg, conditional=False)
    ts_u = PGGANTrainer(cfg_u, base, tcfg).init(jax.random.key(0), 4)
    assert not any(k.startswith("PG.D.Embedding") for k in ts_u.groups["disc"])


def test_stage5_128px_schedule():
    """Resolution schedule beyond 64x64 (the blocks are resolution-agnostic;
    SURVEY §5.7): at ``max_stage=5`` the generator renders 128x128, the
    conditional critic consumes it, the fade-in contract holds at the new
    deepest stage, and init-time output stays unsaturated at EVERY stage —
    the per-block pixel-norm fix must keep holding as depth grows past the
    depth where the stage-3 collapse was observed."""
    from rcgan_tpu.models.pggan import discriminator
    from rcgan_tpu.ops import upsample_depth_to_space

    cfg = PGGANConfig(z_dim=8, dim=8, max_stage=5)  # 4 -> ... -> 128
    base = ResnetGANConfig(dim_g=8, dim_d=8, embedding_dim=12)
    tr = PGGANTrainer(cfg, base, PGGANTrainConfig())
    ts = tr.init(jax.random.key(0), 4)
    z = jax.random.normal(jax.random.key(1), (4, cfg.z_dim))
    y = jnp.arange(4, dtype=jnp.int32) % 10

    # full-resolution sample + conditional critic round-trip
    imgs = tr.sample(ts, z, y, stage=5)
    assert imgs.shape == (4, 128, 128, 3)
    params = merge(*ts.groups.values())
    ctx = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    feat, logit = discriminator(ctx, cfg, base, imgs, stage=5, labels=y)
    assert logit.shape == (4,) and np.all(np.isfinite(np.asarray(logit)))

    # fade-in contract at the deepest stage: alpha=0 IS the upsampled
    # stage-4 image
    ctx = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    out_fade = generator(ctx, cfg, base, z, y, stage=5, trans=True, alpha=0.0)
    ctx2 = Ctx(params=params, state=ts.state, init=False, train=True, update_sn=False)
    out_low = generator(ctx2, cfg, base, z, y, stage=4, trans=False)
    np.testing.assert_allclose(
        np.asarray(out_fade), np.asarray(upsample_depth_to_space(out_low)),
        rtol=1e-5, atol=1e-5,
    )

    # init unsaturation through all five stages.  (At width 8 the
    # per-stage ToRGB init draws are noisy, so the depth-independence
    # ratio is looser than the full-width stage-1..3 test above; the
    # saturation bound is the regression that matters — pre-fix, stage>=3
    # sat at |tanh| = 1.000.)
    means = []
    for stage in (1, 2, 3, 4, 5):
        out = np.abs(np.asarray(tr.sample(ts, z, y, stage=stage)))
        means.append(out.mean())
        assert out.mean() < 0.9, (stage, out.mean())
    assert max(means) < 2.5 * min(means) + 0.05, means


def test_progressive_training_runs_and_learns_all_stages():
    cfg, base, tcfg = tiny()
    tr = PGGANTrainer(cfg, base, tcfg)
    ts = tr.init(jax.random.key(0), 4)
    p0 = jax.tree_util.tree_map(np.asarray, ts.groups)

    rs = np.random.RandomState(0)
    full = cfg.base_size * 2**cfg.max_stage

    def data_fn(it):
        return {
            "x": jnp.asarray(rs.rand(4, full, full, 3).astype(np.float32) * 2 - 1),
            "labels": jnp.asarray(rs.randint(0, 10, 4)),
        }

    logs = []
    ts = tr.train_progressive(ts, data_fn, jax.random.key(2),
                              log_fn=lambda *a: logs.append(a))
    # phases: stage1-stab, stage2-trans, stage2-stab
    assert [(s, t) for s, t, *_ in logs] == [(1, False), (2, True), (2, False)]
    assert all(np.isfinite(m["d_cost"]) and np.isfinite(m["g_cost"])
               for _, _, _, m, _ in logs)
    assert int(ts.step) == 9  # 3 + 3 + 3 iters

    # stage-2 generator block params moved (it trained during stage 2)
    b2 = [k for k in p0["gen"] if k.startswith("PG.G.Block.2")]
    assert b2, f"stage-2 blocks missing from param tree: {sorted(p0['gen'])[:8]}"
    any_moved = any(
        not np.allclose(p0["gen"][k][n], np.asarray(ts.groups["gen"][k][n]))
        for k in b2 for n in p0["gen"][k]
    )
    assert any_moved

    # sampling at the final stage produces full-resolution images
    imgs = tr.sample(ts, jnp.zeros((2, cfg.z_dim)), jnp.zeros((2,), jnp.int32))
    assert imgs.shape == (2, full, full, 3)
    assert np.all(np.abs(np.asarray(imgs)) <= 1.0)


def test_progressive_checkpoint_resume(tmp_path):
    """Crash-resume EQUIVALENCE: a run killed mid-schedule and resumed from
    its phase-boundary checkpoint must land on the same final state as an
    uninterrupted run — the phase plan is derived from ``ts.step``, per-iter
    RNG is ``fold_in(rng, it)``, and ``data_fn`` is a pure function of the
    iteration index (a 10h progressive run killed mid-schedule must not
    restart from scratch)."""
    from rcgan_tpu.train.checkpoint import Checkpointer

    cfg, base, tcfg = tiny()  # phases: 3 + 3 + 3 = 9 iters
    full = cfg.base_size * 2**cfg.max_stage

    def data_fn(it):
        rs = np.random.RandomState(100 + it)
        return {"x": jnp.asarray(rs.rand(4, full, full, 3).astype(np.float32) * 2 - 1),
                "labels": jnp.asarray(rs.randint(0, 10, 4))}

    tr = PGGANTrainer(cfg, base, tcfg)
    ts_a = tr.train_progressive(tr.init(jax.random.key(0), 4), data_fn,
                                jax.random.key(2))

    # crash mid-phase-3 (after 2 phase-boundary saves), then resume fresh
    tr2 = PGGANTrainer(cfg, base, tcfg)
    ck = Checkpointer(str(tmp_path / "ck"))

    class Boom(RuntimeError):
        pass

    def crashing(it):
        if it >= 6:
            raise Boom()
        return data_fn(it)

    import pytest

    with pytest.raises(Boom):
        tr2.train_progressive(tr2.init(jax.random.key(0), 4), crashing,
                              jax.random.key(2), ckpt=ck)
    assert ck.latest_step() == 6

    tr3 = PGGANTrainer(cfg, base, tcfg)  # fresh trainer = fresh process
    ts_r = ck.restore(tr3.init(jax.random.key(0), 4))
    assert int(ts_r.step) == 6
    ts_r = tr3.train_progressive(ts_r, data_fn, jax.random.key(2), ckpt=ck)
    assert int(ts_r.step) == 9 and ck.latest_step() == 9

    flat_a, _ = jax.tree_util.tree_flatten(ts_a.groups)
    flat_r, _ = jax.tree_util.tree_flatten(ts_r.groups)
    for la, lb in zip(flat_a, flat_r):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_pggan_app_end_to_end(tmp_path):
    """The progressive CLI app: native-size synthetic data, pinned
    classifier at the target resolution, per-stage eval rows + sample
    grids + stage_accuracy.json all written."""
    import os

    from rcgan_tpu.apps.pggan_app import main

    run = str(tmp_path / "pg")
    ts, rows = main([
        "--run_dir", run, "--size", "16", "--max_stage", "2", "--dim", "8",
        "--z_dim", "8", "--batch_size", "8", "--trans_iters", "2",
        "--stab_iters", "2", "--train_size", "200", "--eval_samples", "8",
        "--compute_dtype", "float32",
    ])
    # phases: s1 stab, s2 trans, s2 stab -> 3 eval rows
    assert [r["stage"] for r in rows] == [1, 2, 2]
    assert all(0.0 <= r["gen_label_acc"] <= 1.0 for r in rows)
    assert os.path.exists(os.path.join(run, "stage_accuracy.json"))
    assert os.path.exists(os.path.join(run, "samples_stage2_stab.png"))
    assert os.path.exists(os.path.join(run, "config.json"))
    assert int(ts.step) == 6
    # the pinned classifier is cached in the run dir's PARENT under a
    # data-keyed name, so repeat runs on the same data share it
    assert os.path.exists(os.path.join(str(tmp_path), "eval_classifier_16_s0_n200.pkl"))
