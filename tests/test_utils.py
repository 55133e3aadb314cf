"""Utils: image grids, metric logger, run dirs, visualize, prefetcher,
summary writer, conv1d."""

import os

import numpy as np

import jax
import jax.numpy as jnp

from rcgan_tpu.core.module import Ctx, transform
from rcgan_tpu.data.pipeline import Prefetcher
from rcgan_tpu.ops.conv import conv1d_lib
from rcgan_tpu.utils.images import image_manifold_size, merge, save_images, to_uint8_samples
from rcgan_tpu.utils.metrics import MetricLogger
from rcgan_tpu.utils.visualize import make_gif, show_all_variables, visualize


def test_merge_and_save(tmp_path):
    imgs = np.random.RandomState(0).rand(16, 8, 8, 1).astype(np.float32)
    grid = merge(imgs, (4, 4))
    assert grid.shape == (32, 32)
    save_images(imgs, image_manifold_size(16), str(tmp_path / "g.png"))
    assert (tmp_path / "g.png").exists()


def test_to_uint8_samples_range():
    flat = np.array([[-1.0] * 3072, [1.0] * 3072], np.float32)
    out = to_uint8_samples(flat)
    assert out.shape == (2, 32, 32, 3)
    assert out.min() == 0 and out.max() == 255


def test_metric_logger_flush(tmp_path):
    m = MetricLogger()
    for i in range(5):
        m.plot("loss", 1.0 / (i + 1))
        m.tick()
    prints = m.dir_flush(str(tmp_path))
    assert any("loss" in p for p in prints)
    assert (tmp_path / "log.pkl").exists()
    assert (tmp_path / "metrics.jsonl").exists()
    assert m.latest("loss") == 0.2


def test_prefetcher_order_and_error():
    assert list(Prefetcher(iter(range(10)), depth=3)) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("boom")

    it = Prefetcher(boom())
    assert next(it) == 1
    try:
        next(it)
        raise AssertionError("expected RuntimeError")
    except RuntimeError:
        pass


def test_visualize_and_gif(tmp_path):
    def sampler(z, y):
        val = (z[:, :1] + 1) / 2
        return np.ones((len(z), 8, 8, 1), np.float32) * val[:, None, None]

    visualize(sampler, z_dim=4, y_dim=10, batch_size=16, out_dir=str(tmp_path), option=2,
              n_frames=3)
    gifs = [f for f in os.listdir(tmp_path) if f.endswith(".gif")]
    assert len(gifs) == 3
    make_gif([np.zeros((4, 4, 1)), np.ones((4, 4, 1))], str(tmp_path / "x.gif"))
    assert (tmp_path / "x.gif").exists()


def test_visualize_options_3_and_4(tmp_path):
    """Options 3/4 (``mnist/utils.py:219-243``): zero-base batch-axis sweep,
    one GIF per z dim, and option 4's merged forward+reverse grid GIF."""
    def sampler(z, y):
        val = (z.sum(axis=1, keepdims=True) + 1) / 2
        return np.ones((len(z), 8, 8, 1), np.float32) * val[:, None, None]

    visualize(sampler, z_dim=4, y_dim=10, batch_size=16, out_dir=str(tmp_path), option=3)
    gifs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".gif"))
    assert gifs == [f"test_gif_{i}.gif" for i in range(4)]

    visualize(sampler, z_dim=4, y_dim=10, batch_size=16, out_dir=str(tmp_path), option=4)
    assert (tmp_path / "test_gif_merged.gif").exists()


def test_show_all_variables_counts():
    params = {"a": {"w": np.zeros((2, 3))}, "b": {"w": np.zeros((4,))}}
    assert show_all_variables(params) == 10


def test_conv1d_shapes_and_causal_mask():
    x = jnp.ones((2, 16, 4))

    def f(ctx):
        return (
            conv1d_lib(ctx, x, 4, 8, 5, 1, "c1"),
            conv1d_lib(ctx, x, 4, 8, 5, 1, "c2", mask_type=("a", 1)),
        )

    t = transform(f)
    params, state = t.init(jax.random.key(0))
    (o1, o2), _ = t.apply(params, state, None)
    assert o1.shape == (2, 16, 8) and o2.shape == (2, 16, 8)

    # causal: output at position t must not depend on inputs > t
    x2 = x.at[:, 10:, :].set(99.0)
    ctx = Ctx(params=params, state=state, init=False)
    o2b = conv1d_lib(ctx, x2, 4, 8, 5, 1, "c2", mask_type=("a", 1))
    np.testing.assert_allclose(o2[:, :10], o2b[:, :10], rtol=1e-5)


def test_summary_writer_writes_events(tmp_path):
    from rcgan_tpu.utils.summary import SummaryWriter

    w = SummaryWriter(str(tmp_path))
    w.scalar("x", 1.5, 0)
    w.histogram("h", np.random.rand(100), 0)
    w.image("img", np.zeros((8, 8, 1), np.uint8), 0)
    w.flush()
    files = os.listdir(tmp_path)
    assert any("tfevents" in f for f in files) or not files  # no-op mode allowed


def test_record_setting_script_file(tmp_path):
    import pytest

    from rcgan_tpu.utils.run_dir import record_setting

    script = tmp_path / "run_it.sh"
    script.write_text("#!/bin/bash\necho hi\n")
    out = tmp_path / "run"
    record_setting(str(out), {"a": 1}, script_file=str(script))
    assert (out / "scripts" / "run_it.sh").exists()
    assert (out / "scripts" / "rcgan_tpu" / "config.py").exists()
    assert (out / "command.txt").exists()

    with pytest.raises(FileNotFoundError):
        record_setting(str(tmp_path / "run2"), script_file=str(tmp_path / "nope.sh"))


def test_metric_logger_plot_at_and_history(tmp_path):
    m = MetricLogger()
    m.plot_at("acc", 0.5, 10)
    m.plot_at("acc", 0.7, 30)
    prints = m.dir_flush(str(tmp_path))
    assert prints == ["acc: 0.6"]
    # second flush only summarizes the new tail
    m.plot_at("acc", 0.9, 40)
    assert m.dir_flush(str(tmp_path)) == ["acc: 0.9"]
    steps, values = m.history("acc")
    assert list(steps) == [10, 30, 40]
    assert m.latest("acc") == 0.9
    assert (tmp_path / "metrics.jsonl").exists()
