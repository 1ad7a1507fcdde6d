"""The port's data pipeline, checkpointing and fault-tolerant runner: twins
of ``tests/test_data_ckpt_ft.py``, plus the same batches and snapshot
files as the reference's, and a recovered training run that ends where an
uninterrupted one does."""
import contextlib
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")  # CI images without torch skip the port

from repro.ckpt import checkpoint as R_ckpt
from repro.data import pipeline as R_data

from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint, save_checkpoint)
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import (DataConfig, ShardedTokenPipeline,
                                       write_synthetic_corpus)
from repro_torch.ft.manager import FaultTolerantRunner, StragglerMonitor
from repro_torch.optim.tree import leaves
from repro_torch.train import steps as P_steps


# ------------------------------------------------------------------- data
def test_pipeline_pure_in_step():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4)
    p1, p2 = ShardedTokenPipeline(cfg), ShardedTokenPipeline(cfg)
    for step in (0, 7, 123):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_labels_shifted():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2)
    b = ShardedTokenPipeline(cfg).batch_at(3)
    assert b["tokens"].shape == (2, 16) and b["labels"].shape == (2, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_corpus_host_sharding(tmp_path):
    write_synthetic_corpus(str(tmp_path), vocab_size=50, n_tokens=4000,
                           n_shards=4)
    cfgs = [DataConfig(vocab_size=50, seq_len=8, global_batch=4,
                       corpus_dir=str(tmp_path), host_id=h, num_hosts=2)
            for h in range(2)]
    pipes = [ShardedTokenPipeline(c) for c in cfgs]
    b0, b1 = pipes[0].batch_at(5), pipes[1].batch_at(5)
    assert b0["tokens"].shape == (2, 8)             # host slice of global 4
    assert not np.array_equal(b0["tokens"], b1["tokens"])


@pytest.mark.parametrize("corpus", [False, True])
def test_batches_equal_the_reference(tmp_path, corpus):
    """Every step, host and corpus: the port's batches == the reference's,
    and the corpus files it writes are the reference's byte for byte."""
    kw = {}
    if corpus:
        ours, theirs = tmp_path / "port", tmp_path / "ref"
        write_synthetic_corpus(str(ours), vocab_size=50, n_tokens=3000,
                               n_shards=3, seed=11)
        R_data.write_synthetic_corpus(str(theirs), vocab_size=50,
                                      n_tokens=3000, n_shards=3, seed=11)
        for a in sorted(ours.iterdir()):
            assert a.read_bytes() == (theirs / a.name).read_bytes()
        kw = dict(corpus_dir=str(ours))
    for host in range(2):
        mine = ShardedTokenPipeline(DataConfig(
            vocab_size=50, seq_len=8, global_batch=4, host_id=host,
            num_hosts=2, **kw))
        ref = R_data.ShardedTokenPipeline(R_data.DataConfig(
            vocab_size=50, seq_len=8, global_batch=4, host_id=host,
            num_hosts=2, **kw))
        for step in (0, 1, 9, 1000):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------------- ckpt
def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v, dtype=torch.bfloat16)},
            "step": torch.tensor(int(v), dtype=torch.int32)}


def test_checkpoint_roundtrip_bf16(tmp_path):
    s = _state(3.0)
    path = save_checkpoint(str(tmp_path), 7, s)
    got = load_checkpoint(path, _state())
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["w"].float().numpy(),
                                  np.full((4, 4), 3.0, np.float32))
    assert int(got["step"]) == 3 and got["step"].dtype == torch.int32


def test_no_tmp_files_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _state())
    assert not list(pathlib.Path(tmp_path).glob("*.tmp"))


def test_manager_retention_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
    for s in range(5):
        mgr.maybe_save(s, _state(float(s)))
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    files = sorted(pathlib.Path(tmp_path).glob("*.npz"))
    assert len(files) == 2                           # retention
    step, got = mgr.restore_latest(_state())
    assert step == 4
    np.testing.assert_allclose(got["params"]["w"].float().numpy(), 4.0)


def test_manager_snapshots_at_save_time(tmp_path):
    """The background save writes the state as it was when asked, even if
    the caller's tensors change before the write."""
    mgr = CheckpointManager(str(tmp_path), keep=3, every=1)
    s = _state(1.0)
    mgr.maybe_save(0, s)
    s["params"]["w"].fill_(9.0)
    mgr.wait()
    _, got = mgr.restore_latest(_state())
    assert float(got["params"]["w"][0, 0]) == 1.0


def _mixed_state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"layers": {"wq": rng.standard_normal((2, 3, 4))},
                       "embed": rng.standard_normal((5, 4)),
                       "norm": rng.standard_normal(4)},
            "opt": {"m": {"w": rng.standard_normal((2, 2))},
                    "v": {"w": rng.random((2, 2))}},
            "step": np.int32(seed)}


def _as(tree, kind):
    """A numpy tree as jax or torch leaves: ``params`` in bf16, the rest
    f32 and the step int32."""
    def conv(path, a):
        bf = path.startswith("params")
        if kind == "jax":
            return jnp.asarray(a, jnp.bfloat16 if bf else
                               (jnp.int32 if path == "step" else jnp.float32))
        t = torch.from_numpy(np.asarray(a, np.float32 if path != "step"
                                        else np.int32))
        return t.to(torch.bfloat16) if bf else t

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}".lstrip("/"))
                    for k, v in node.items()}
        return conv(path, node)
    return walk(tree)


def _numpy_of(tree):
    if isinstance(tree, dict):
        return {k: _numpy_of(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype.kind == "V" else a


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    """A snapshot either package writes loads in the other, leaf for leaf
    ==, in the reader's dtypes; the npz keys are the same paths."""
    src = _mixed_state(5)
    jstate, tstate = _as(src, "jax"), _as(src, "torch")
    if writer == "reference":
        path = R_ckpt.save_checkpoint(str(tmp_path), 3, jstate)
        got = load_checkpoint(path, _as(_mixed_state(0), "torch"))
        want = tstate
    else:
        path = save_checkpoint(str(tmp_path), 3, tstate)
        got = R_ckpt.load_checkpoint(path, jax.tree_util.tree_map(
            np.asarray, _as(_mixed_state(0), "jax")))
        want = jax.tree_util.tree_map(np.asarray, jstate)
    with np.load(path) as z:
        assert sorted(z.files) == ["opt/m/w", "opt/v/w", "params/embed",
                                   "params/layers/wq", "params/norm", "step"]
        assert z["params/embed"].dtype == np.float32
        assert z["step"].dtype == np.int32
    for a, b in zip(jax.tree_util.tree_leaves(_numpy_of(got)),
                    jax.tree_util.tree_leaves(_numpy_of(want))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if writer == "reference":
        assert got["params"]["embed"].dtype == torch.bfloat16
        assert got["step"].dtype == torch.int32


# --------------------------------------------------------------------- ft
def test_runner_recovers_from_injected_failure(tmp_path):
    calls = []

    def step_fn(state, batch):
        s = dict(state, step=state["step"] + 1)
        calls.append(int(state["step"]))
        return s, {"loss": 1.0 / (1 + float(state["step"]))}

    runner = FaultTolerantRunner(str(tmp_path), save_every=3)
    state = {"step": torch.tensor(0, dtype=torch.int32)}
    final, report = runner.run(state, 12, step_fn, lambda i: None,
                               log_every=0, fail_at=7)
    assert report.failures_recovered == 1
    assert int(final["step"]) == 12
    # resumed from the last checkpoint before the failure (step 6)
    assert 6 in calls or 7 in calls


def test_runner_auto_resume_fresh_process(tmp_path):
    def step_fn(state, batch):
        return dict(state, step=state["step"] + 1), {"x": 0.0}

    r1 = FaultTolerantRunner(str(tmp_path), save_every=2)
    s, _ = r1.run({"step": torch.tensor(0, dtype=torch.int32)}, 6, step_fn,
                  lambda i: None, log_every=0)
    # second runner: resumes, runs only the remaining steps
    r2 = FaultTolerantRunner(str(tmp_path), save_every=2)
    s2, rep = r2.run({"step": torch.tensor(0, dtype=torch.int32)}, 10,
                     step_fn, lambda i: None, log_every=0)
    assert rep.resumed_from == 5
    assert int(s2["step"]) == 10


def test_straggler_monitor_flags_outliers():
    m = StragglerMonitor(window=16, threshold=2.0)
    flagged = []
    for i in range(20):
        t = 0.1 if i != 15 else 0.5
        if m.observe(i, t):
            flagged.append(i)
    assert flagged == [15]
    assert m.report()["n_straggles"] == 1


def _train(tmp, fail_at):
    """Eight steps of qwen1.5-0.5b's reduced config (bf16) under the
    runner, snapshots every 3, from the pipeline's batches."""
    cfg = registry.reduced_config("qwen1.5-0.5b")
    state = P_steps.init_train_state(torch.Generator().manual_seed(0), cfg)
    step = P_steps.make_train_step(cfg, TrainConfig(warmup_steps=2,
                                                    total_steps=8))
    data = ShardedTokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=16, global_batch=2))

    def batch_at(i):
        return {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
    with contextlib.redirect_stdout(io.StringIO()):
        return FaultTolerantRunner(str(tmp), save_every=3).run(
            state, 8, step, batch_at, log_every=1, fail_at=fail_at)


def test_recovered_run_ends_where_an_uninterrupted_one_does(tmp_path):
    """A failure injected at step 5 rolls back to the step-3 snapshot and
    replays: the final state (parameters, moments, step) == the run
    without the failure, and so are the last metrics."""
    clean, rep_clean = _train(tmp_path / "clean", None)
    recovered, rep = _train(tmp_path / "failed", 5)
    assert (rep_clean.failures_recovered, rep.failures_recovered) == (0, 1)
    assert rep.final_metrics == rep_clean.final_metrics
    assert int(recovered["step"]) == int(clean["step"]) == 8
    for a, b in zip(leaves(recovered), leaves(clean)):
        assert a.dtype == b.dtype and torch.equal(a, b)
