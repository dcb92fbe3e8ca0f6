"""The port's optimizer, data stream, gradient compression, checkpoints,
straggler monitor and training launcher against the reference's, on the
CPU.

AdamW from identical gradients agrees within 1e-6 relative over three
steps through warm-up and the cosine (the reductions of the global norm
sum in another order); the data stream and the int8 compression are
bitwise the reference's; checkpoints keep the reference's on-disk layout,
so a plain tree saved by either package restores in the other, and the
cases of tests/test_ft.py hold for the port's manager.  The launcher runs
the smoke model twice with the same losses, and a --resume run from its
checkpoint repeats the later losses.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.ft import CheckpointManager as JCheckpointManager
from repro.runtime import compression as jcompression
from repro.train import optimizer as jopt
from repro_torch.core import fabric
from repro_torch.data import pipeline
from repro_torch.ft import CheckpointManager, HeartbeatMonitor
from repro_torch.launch import train
from repro_torch.runtime import compression
from repro_torch.train import optimizer as opt

SHAPES = {"embed": (64, 16), "ln": (16,), "w": (16, 24), "moe": (3, 8, 5)}
OPT_RTOL = 1e-6


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got: torch.Tensor, want, rtol=OPT_RTOL):
    """Each element within rtol of the leaf's largest magnitude."""
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= rtol * scale


def test_adamw_matches_reference_through_warmup_and_cosine():
    """Three steps from identical gradients (the third past warm-up, on
    the cosine), the second gradient clipped (norm above clip_norm)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0)
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    p0 = _np_tree(0)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = opt.adamw_init(params)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.adamw_init(jparams)
    jupdate = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))
    for i, scale in enumerate((0.01, 3.0, 0.2)):
        g = _np_tree(10 + i, scale)
        params, state, norm = opt.adamw_update(
            cfg, params, {k: torch.from_numpy(v) for k, v in g.items()},
            state)
        jparams, jstate, jnorm = jupdate(
            jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        assert abs(float(norm) - float(jnorm)) <= OPT_RTOL * float(jnorm)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        assert state["step"].dtype == torch.int32
        for k in SHAPES:
            _close(params[k], jparams[k])
            _close(state["m"][k], jstate["m"][k])
            _close(state["v"][k], jstate["v"][k])


@pytest.mark.parametrize("step", [0, 1, 3, 5, 50, 99, 100, 101, 4000, 10000,
                                  12000])
def test_schedule_matches_reference(step):
    cfg = opt.AdamWConfig()
    want = float(jopt.schedule(jopt.AdamWConfig(), jnp.asarray(step)))
    got = float(opt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= OPT_RTOL * max(abs(want), 1e-12)


@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_batches_bitwise_reference(host_id, n_hosts):
    kw = dict(vocab_size=32003, batch=8, seq=37, seed=5, host_id=host_id,
              n_hosts=n_hosts)
    for step in (0, 1, 17):
        got = pipeline._batch_at(pipeline.DataConfig(**kw), step)
        want = jpipeline._batch_at(jpipeline.DataConfig(**kw), step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    stream = pipeline.synthetic_stream(pipeline.DataConfig(**kw),
                                       start_step=16)
    next(stream)
    np.testing.assert_array_equal(next(stream)["tokens"], want["tokens"])


def _grad_rows(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((6, 33)) * rng.uniform(1e-3, 10, (6, 1))
         ).astype(np.float32)
    # ties at .5 after scaling: 127 sets the scale to 1, so 0.5, 1.5, 2.5
    # and -3.5 round half to even
    g[0, :5] = [127.0, 0.5, 1.5, 2.5, -3.5]
    g[1] = 0.0                      # an all-zero row: the 1e-12 floor
    return g


def test_quantize_bitwise_reference():
    g = _grad_rows(0)
    q, s = compression.quantize(torch.from_numpy(g))
    jq, js = jcompression.quantize(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, :5].tolist() == [127, 0, 2, 2, -4]
    np.testing.assert_array_equal(
        compression.dequantize(q, s).numpy(),
        np.asarray(jcompression.dequantize(jq, js)))


def test_compress_grads_bitwise_reference_and_error_feedback():
    """Three steps of compress_grads on a tree: payloads and errors bitwise
    the reference's, and the dequantized payloads plus the last error sum
    to the gradients' sum."""
    tree = {"a": _grad_rows(1), "b": [_grad_rows(2)[:, :7]]}
    err = compression.init_error(
        {"a": torch.zeros(6, 33), "b": [torch.zeros(6, 7)]})
    jerr = jcompression.init_error(jax.tree.map(jnp.asarray, tree))
    total = jax.tree.map(lambda x: np.zeros(x.shape, np.float64), tree)
    sent = jax.tree.map(lambda x: np.zeros(x.shape, np.float64), tree)
    for step in range(3):
        g = jax.tree.map(lambda x: x * (1 + step), tree)
        payload, err = compression.compress_grads(
            jax.tree.map(torch.from_numpy, g), err)
        jpayload, jerr = jcompression.compress_grads(
            jax.tree.map(jnp.asarray, g), jerr)
        for (a, b) in ((payload["a"], jpayload["a"]),
                       (payload["b"][0], jpayload["b"][0])):
            np.testing.assert_array_equal(a["q"].numpy(), np.asarray(b["q"]))
            np.testing.assert_array_equal(a["scale"].numpy(),
                                          np.asarray(b["scale"]))
        np.testing.assert_array_equal(err["a"].numpy(), np.asarray(jerr["a"]))
        np.testing.assert_array_equal(err["b"][0].numpy(),
                                      np.asarray(jerr["b"][0]))
        assert compression.compressed_bytes(payload) == \
            jcompression.compressed_bytes(jpayload)
        deq = compression.decompress_grads(payload)
        total = jax.tree.map(lambda t, x: t + x, total, g)
        sent = jax.tree.map(lambda t, x: t + x.numpy(), sent, deq)
    for k in ("a", "b"):
        t = total[k] if k == "a" else total[k][0]
        got = (sent[k] if k == "a" else sent[k][0]) + (
            err[k] if k == "a" else err[k][0]).numpy()
        np.testing.assert_allclose(got, t, rtol=0,
                                   atol=1e-5 * np.abs(t).max())


# -- checkpoints: tests/test_ft.py for the port ------------------------------

def tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones((4,)), torch.zeros((), dtype=torch.int32)],
            "c": {"d": torch.full((2, 2), 7.0)}}


def _leaves(t):
    from repro_torch import tree as ptree
    return [leaf for _, leaf in ptree.flatten(t)]


def test_save_restore_roundtrip(tmp_path):
    cm = CheckpointManager(tmp_path)
    t = tree()
    cm.save(5, t, extra={"loss": 1.25})
    got, manifest = cm.restore({k: v for k, v in _zeros_like(t).items()})
    assert manifest["step"] == 5
    assert manifest["extra"]["loss"] == 1.25
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _zeros_like(t):
    from repro_torch import tree as ptree
    return ptree.map_with_path(lambda _, x: torch.zeros_like(x), t)


def test_latest_and_gc(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree())
    assert cm.latest_step() == 4
    dirs = sorted(p.name for p in tmp_path.glob("step_*"))
    assert dirs == ["step_00000003", "step_00000004"]


def test_crash_mid_save_keeps_previous(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, tree())
    bad = tmp_path / "step_00000002.tmp"
    bad.mkdir()
    (bad / "arrays.npz").write_bytes(b"garbage")
    assert cm.latest_step() == 1
    _, m = cm.restore(_zeros_like(tree()))
    assert m["step"] == 1


def test_stale_latest_falls_back_to_newest(tmp_path):
    """LATEST names a directory that is gone: the newest finished step
    directory is restored (a crashed save's .tmp is not one)."""
    import shutil
    cm = CheckpointManager(tmp_path)
    cm.save(3, tree())
    cm.save(6, tree())
    shutil.rmtree(tmp_path / "step_00000006")
    (tmp_path / "step_00000009.tmp").mkdir()
    assert (tmp_path / "LATEST").read_text() == "step_00000006"
    assert cm.latest_step() == 3
    _, m = cm.restore(_zeros_like(tree()))
    assert m["step"] == 3


def test_restore_places_leaves_on_device(tmp_path):
    """restore(device=...) places every tensor leaf on that device: the
    one-device counterpart of the reference's shardings=."""
    cm = CheckpointManager(tmp_path)
    cm.save(1, tree())
    got, _ = cm.restore(_zeros_like(tree()), device="cpu")
    for leaf in _leaves(got):
        assert leaf.device == torch.device("cpu")
    meta = {"a": torch.empty((2, 3), device="meta")}
    got, _ = cm.restore(meta, device=torch.device("cpu"), strict=False)
    assert got["a"].device.type == "cpu"
    assert torch.equal(got["a"], tree()["a"])


def test_shape_mismatch_raises(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        cm.restore({"a": torch.zeros((3, 3))})
    with pytest.raises(KeyError, match="missing b"):
        cm.restore({"a": torch.zeros((2, 2)), "b": torch.zeros(1)})
    got, _ = cm.restore({"a": torch.zeros((2, 2)), "b": torch.ones(1)},
                        strict=False)
    assert torch.equal(got["b"], torch.ones(1))


def test_bf16_leaf_raises_naming_it(tmp_path):
    cm = CheckpointManager(tmp_path)
    with pytest.raises(TypeError, match="'w/0'.*bfloat16"):
        cm.save(1, {"w": [torch.zeros(2, dtype=torch.bfloat16)]})


def test_layout_matches_reference(tmp_path):
    """The same tree saved by both packages: the same files, manifest and
    arrays."""
    t = tree()
    CheckpointManager(tmp_path / "port").save(2, t, extra={"x": 1})
    JCheckpointManager(tmp_path / "ref").save(
        2, jax.tree.map(lambda x: jnp.asarray(x.numpy()), t), extra={"x": 1})
    for root in ("port", "ref"):
        d = tmp_path / root
        assert sorted(p.name for p in d.iterdir()) == ["LATEST",
                                                       "step_00000002"]
        assert sorted(p.name for p in (d / "step_00000002").iterdir()) == [
            "arrays.npz", "manifest.json"]
    mp, mr = (json.loads((tmp_path / r / "step_00000002" / "manifest.json")
                         .read_text()) for r in ("port", "ref"))
    assert mp == mr
    with np.load(tmp_path / "port/step_00000002/arrays.npz") as a, \
            np.load(tmp_path / "ref/step_00000002/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(mr["keys"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoints_restore_across_packages(tmp_path):
    t = tree()
    CheckpointManager(tmp_path / "port").save(4, t)
    got, m = JCheckpointManager(tmp_path / "port").restore(
        jax.tree.map(lambda x: jnp.zeros(x.shape, x.numpy().dtype), t))
    assert m["step"] == 4
    for a, b in zip(_leaves(t), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    JCheckpointManager(tmp_path / "ref").save(
        7, jax.tree.map(lambda x: jnp.asarray(x.numpy()) + 1, t))
    got, m = CheckpointManager(tmp_path / "ref").restore(_zeros_like(t))
    assert m["step"] == 7
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a + 1, b)


def test_straggler_monitor_flags_and_escalates():
    mon = HeartbeatMonitor(threshold=2.0, persistent_after=2)
    for i in range(10):
        assert mon.observe(i, 1.0) is None
    ev = mon.observe(10, 5.0)
    assert ev is not None and ev.severity == pytest.approx(5.0)
    assert not mon.persistent
    mon.observe(11, 5.0)
    assert mon.persistent
    mon.step_start()
    assert mon.step_end(12) is None


def test_derated_fabric():
    mon = HeartbeatMonitor()
    spec = fabric.v5e_fabric()
    d = mon.derated_fabric(spec, axis=1, factor=0.5)
    assert isinstance(d, fabric.FabricSpec)
    assert d.axis_bw[1] == spec.axis_bw[1] * 0.5
    assert d.axis_bw[0] == spec.axis_bw[0]


# -- the launcher ------------------------------------------------------------

def test_train_launcher_repeats_and_resumes(tmp_path, capsys):
    """The port's counterpart of the reference's training example on the
    smoke model: two runs give the same losses; deleting the last
    checkpoint and rerunning with --resume restarts from the earlier one
    (LATEST is stale) and repeats the later losses."""
    argv = ["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "32", "--log-every",
            "1", "--ckpt-every", "3"]
    first = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    second = train.main(argv)
    assert len(first) == 6 and all(np.isfinite(first))
    assert first == second
    out = capsys.readouterr().out
    assert "coflow plan:" in out and "final loss" in out
    ckpts = sorted(p.name for p in (tmp_path / "a").glob("step_*"))
    assert ckpts == ["step_00000003", "step_00000006"]
    import shutil
    shutil.rmtree(tmp_path / "a" / "step_00000006")
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "a"),
                                 "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert resumed == first[3:]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "seamless-m4t-large-v2", "internvl2-1b"])
def test_train_launcher_other_families(arch, capsys):
    """MoE, encoder-decoder (zero frame embeddings) and VLM (zero image
    embeddings) through the launcher."""
    losses = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "params:" in capsys.readouterr().out


def test_train_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--smoke", "--steps", "1"])
