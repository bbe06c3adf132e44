"""Port parity: training checkpoints, the data pipeline and the training
driver against the JAX package (``test_train_substrate.py``'s cases).

Checkpoints interchange: each package restores what the other wrote,
leaf for leaf and bit for bit, where the JAX package can read it (not a
bfloat16 leaf: its ``restore`` hands ``jnp.asarray`` a ``|V2`` array),
and the files the port writes are the JAX package's, byte for byte.
Batches are the JAX pipeline's numpy arrays exactly.
"""
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.data.pipeline import synth_batch as jax_synth_batch
from repro.train import checkpoint as jckpt

import torch
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import Prefetcher, synth_batch
from repro_torch.launch import train as ttrain
from repro_torch.models.param import leaves
from repro_torch.train import checkpoint as ckpt

from torch_threads import one_thread  # noqa: F401


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "nested": {"b": torch.ones((4,), dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _jax_tree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "nested": {"b": jnp.ones((4,), jnp.int32)},
            "step": jnp.asarray(7, jnp.int32)}


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(a, b):
    got, want = dict(leaves(a)), dict(leaves(b))
    assert got.keys() == want.keys()
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        assert torch.equal(_bits(got[path]), _bits(want[path])), path


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path)
    t = _tree()
    t["h"] = torch.randn((3, 5)).to(torch.bfloat16)
    ckpt.save(d, 10, t)
    _same(ckpt.restore(d, 10, t), t)


def test_checkpoint_latest_and_prune(tmp_path):
    d = str(tmp_path)
    t = _tree()
    for s in (1, 5, 3):
        ckpt.save(d, s, t)
    assert ckpt.latest_step(d) == 5
    ckpt.prune(d, keep=1)
    assert ckpt.latest_step(d) == 5
    assert not os.path.exists(os.path.join(d, "step_1"))


def test_checkpoint_async(tmp_path):
    d = str(tmp_path)
    t = _tree()
    th = ckpt.save(d, 2, t, asynchronous=True)
    t["a"].add_(1)          # the leaves were copied before the write
    th.join(timeout=30)
    assert ckpt.latest_step(d) == 2
    assert ckpt.restore(d, 2, t)["a"][0, 0] == 0


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path)
    t = _tree()
    ckpt.save(d, 1, t)
    f = sorted(glob.glob(os.path.join(d, "step_1", "*.npy")))[0]
    np.save(f, np.load(f) + 1)
    with pytest.raises(IOError):
        ckpt.restore(d, 1, t)
    ckpt.restore(d, 1, t, verify=False)


def test_checkpoint_torn_write_invisible(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_9.tmp"))
    assert ckpt.latest_step(d) is None


def test_restore_latest_resume(tmp_path):
    d = str(tmp_path)
    t = _tree()
    ckpt.save(d, 42, t)
    out = ckpt.restore_latest(d, t)
    assert out is not None
    tree, step = out
    assert step == 42
    _same(tree, t)
    assert ckpt.restore_latest(str(tmp_path / "none"), t) is None


def test_jax_checkpoint_restored_by_the_port_and_back(tmp_path):
    """A JAX-written float32/int32 checkpoint restored by the port, and
    the port's restored by the JAX package, bit for bit; the two writers'
    files and manifests are identical."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jd, 3, _jax_tree())
    _same(ckpt.restore(jd, 3, _tree()), _tree())
    ckpt.save(td, 3, _tree())
    back = jckpt.restore(td, 3, _jax_tree())
    for (path, a), (_, b) in zip(leaves(jax.tree.map(np.asarray, back)),
                                 leaves(jax.tree.map(np.asarray,
                                                     _jax_tree()))):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    for name in sorted(os.listdir(os.path.join(jd, "step_3"))):
        with open(os.path.join(jd, "step_3", name), "rb") as f, \
                open(os.path.join(td, "step_3", name), "rb") as g:
            assert f.read() == g.read(), name


def test_jax_bfloat16_leaf_restored_by_the_port(tmp_path):
    """A bfloat16 leaf (``'<V2'``, manifest ``"bfloat16"``) as the JAX
    package writes it: the port restores it as ``torch.bfloat16`` bit for
    bit, and writes the same file bytes."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jd, 1, {"a": jnp.asarray(a, jnp.bfloat16),
                       "b": jnp.ones((3,), jnp.float32)})
    like = {"a": torch.zeros((2, 3), dtype=torch.bfloat16),
            "b": torch.zeros(3)}
    got = ckpt.restore(jd, 1, like)
    want = torch.from_numpy(a).to(torch.bfloat16)
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"].view(torch.int16), want.view(torch.int16))
    ckpt.save(td, 1, {"a": want, "b": torch.ones(3)})
    for name in ("a.npy", "b.npy", "manifest.json"):
        with open(os.path.join(jd, "step_1", name), "rb") as f, \
                open(os.path.join(td, "step_1", name), "rb") as g:
            assert f.read() == g.read(), name
    raw = np.load(os.path.join(td, "step_1", "a.npy"))
    assert raw.dtype == np.dtype("V2")
    assert np.array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                          want.float().numpy())


def test_data_determinism_and_restart():
    cfg = smoke_config("qwen3-8b")
    shape = ShapeConfig("t", 16, 8, "train")
    b1 = synth_batch(cfg, shape, step=5, seed=1)
    b2 = synth_batch(cfg, shape, step=5, seed=1)   # restart: same step
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = synth_batch(cfg, shape, step=6, seed=1)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-large-v3"])
def test_batches_are_the_jax_pipeline_s(arch):
    for pi in (0, 1):
        got = synth_batch(smoke_config(arch), ShapeConfig("t", 16, 8,
                                                          "train"),
                          3, seed=2, process_index=pi, process_count=2)
        want = jax_synth_batch(jax_smoke_config(arch),
                               JaxShapeConfig("t", 16, 8, "train"), 3,
                               seed=2, process_index=pi, process_count=2)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_host_sharding_disjoint():
    cfg = smoke_config("qwen3-8b")
    shape = ShapeConfig("t", 16, 8, "train")
    h0 = synth_batch(cfg, shape, 0, seed=1, process_index=0, process_count=2)
    h1 = synth_batch(cfg, shape, 0, seed=1, process_index=1, process_count=2)
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_prefetcher():
    cfg = smoke_config("qwen3-8b")
    shape = ShapeConfig("t", 16, 4, "train")
    pf = Prefetcher(lambda s: synth_batch(cfg, shape, s, seed=0),
                    start_step=3, device="cpu")
    it = iter(pf)
    s, b = next(it)
    assert s == 3 and isinstance(b["tokens"], torch.Tensor)
    assert np.array_equal(b["tokens"].numpy(),
                          synth_batch(cfg, shape, 3, seed=0)["tokens"])
    s, b = next(it)
    assert s == 4
    pf.close()
    assert not pf._thread.is_alive()
    pf = Prefetcher(lambda s: s, start_step=0, put_fn=lambda x: x * 10)
    it = iter(pf)
    assert [next(it) for _ in range(3)] == [(0, 0), (1, 10), (2, 20)]
    pf.close()


def test_train_main_resumes(tmp_path, capsys):
    """``launch.train.main --smoke --device cpu``: 6 steps with a
    checkpoint every 2 (async) and at the end; with the last one gone (a
    run killed after step 4), the same command resumes from step 4, and
    its steps 4–5 give the uninterrupted run's losses (the same batches
    from the pipeline, the same state from the checkpoint)."""
    d = str(tmp_path / "ck")
    argv = ["--arch", "whisper-large-v3", "--smoke", "--device", "cpu",
            "--seq", "16", "--batch", "4", "--lr", "1e-3", "--ckpt-every",
            "2", "--log-every", "1", "--steps", "6", "--ckpt-dir", d]
    whole = ttrain.main(argv)
    assert whole["steps"] == 6 and np.isfinite(whole["first_loss"])
    assert sorted(os.listdir(d)) == ["step_2", "step_4", "step_6"]
    import shutil
    shutil.rmtree(os.path.join(d, "step_6"))
    capsys.readouterr()
    resumed = ttrain.main(argv)
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed["steps"] == 2 and ckpt.latest_step(d) == 6
    np.testing.assert_allclose(resumed["last_loss"], whole["last_loss"],
                               rtol=1e-6)


def test_train_main_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])
