"""PyTorch port, checkpoint and resume: ``train/checkpoint.py``,
``train/preemption.py``, ``utils/ckpt.py`` and ``fit``'s restore-on-start,
preemption and save hooks, held to the contracts the JAX package's tests
pin for its own (``tests/test_checkpoint.py`` but the elastic and sharded
cases, ``tests/test_preemption.py``, the checkpoint cases of
``tests/test_faults.py``), and to the JAX package's control plane, which
must read the port's directories unchanged.

End to end, the MNIST CLI (``python -m
k8s_distributed_deeplearning_torch.train.mnist --device cpu``): one
process SIGTERMed and run again, and a gang of 2 gloo ranks SIGKILLed
after a save and restarted, each end with parameters and Adam moments
bitwise equal to an unkilled run's (replay-free resume makes that an
equality, not a tolerance), and only rank 0 writes.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker
from k8s_distributed_deeplearning_torch.models import mnist as t_mnist
from k8s_distributed_deeplearning_torch.parallel import (
    data_parallel as t_dp)
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist
from k8s_distributed_deeplearning_torch.train import data as t_data
from k8s_distributed_deeplearning_torch.train import loop as t_loop
from k8s_distributed_deeplearning_torch.train import optim as t_optim
from k8s_distributed_deeplearning_torch.train.checkpoint import Checkpointer
from k8s_distributed_deeplearning_torch.train.preemption import (
    PreemptionHandler)
from k8s_distributed_deeplearning_torch.utils import ckpt as t_ckpt
from k8s_distributed_deeplearning_tpu import faults
from k8s_distributed_deeplearning_tpu.utils import ckpt as j_ckpt

REPO = Path(__file__).resolve().parents[1]

torch.set_num_threads(2)


def _state(val):
    return {"params": {"w": torch.full((3, 2), float(val))}, "step": 7}


def _kept(directory):
    return {int(p.name) for p in Path(directory).iterdir()
            if p.name.isdigit()}


def test_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    ckpt.save(10, _state(1.5))
    template = _state(0.0)
    w = template["params"]["w"]
    restored, step = ckpt.restore_latest(template)
    assert step == 10 and restored["step"] == 7
    assert restored["params"]["w"] is w          # written in place
    np.testing.assert_array_equal(w.numpy(), np.full((3, 2), 1.5))
    ckpt.close()


def test_restore_empty_returns_none(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "empty"))
    assert ckpt.restore_latest(_state(0.0)) is None
    assert ckpt.latest_step() is None
    assert not (tmp_path / "empty").exists()     # nothing was written


def test_latest_wins_and_max_to_keep(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    for s, v in [(1, 1.0), (2, 2.0), (3, 3.0)]:
        assert ckpt.save(s, _state(v))
    assert not ckpt.save(3, _state(9.0))         # committed: not again
    assert not ckpt.save(2, _state(9.0))         # older than the newest
    restored, step = ckpt.restore_latest(_state(0.0))
    assert step == 3
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((3, 2), 3.0))
    assert ckpt.latest_step() == 3
    assert _kept(ckpt.directory) == {2, 3}
    # manifests of collected steps are gone too
    assert sorted(os.listdir(ckpt.directory)) == [
        "2", "3", "manifest-2.json", "manifest-3.json"]


def test_best_checkpoint_survives_max_to_keep(tmp_path):
    """save_best_only parity: the 2 best by accuracy (3 and 2) are kept,
    plus the newest save (the crash-resume recency slot)."""
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2,
                        keep_best_metric="accuracy", best_mode="max")
    for s, acc in [(1, 0.50), (2, 0.80), (3, 0.95), (4, 0.70), (5, 0.60),
                   (6, 0.65)]:
        ckpt.save(s, _state(s), metrics={"accuracy": acc})
    assert ckpt.best_step() == 3
    assert _kept(ckpt.directory) == {2, 3, 6}
    restored, step = ckpt.restore_latest(_state(0.0))
    assert step == 6
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((3, 2), 6.0))
    best, bstep = ckpt.restore_best(_state(0.0))
    assert bstep == 3 and float(best["params"]["w"][0, 0]) == 3.0


def test_best_mode_min_and_metricless_saves(tmp_path):
    """best_mode='min'; a metric-less periodic save is collected once it
    is not the newest, never displacing a best checkpoint."""
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2,
                        keep_best_metric="loss", best_mode="min")
    ckpt.save(1, _state(1.0), metrics={"loss": 0.9})
    ckpt.save(2, _state(2.0), metrics={"loss": 0.2})   # best
    ckpt.save(3, _state(3.0))                          # periodic, no metric
    ckpt.save(4, _state(4.0), metrics={"loss": 0.5})
    assert ckpt.best_step() == 2
    assert _kept(ckpt.directory) == {2, 4}


def test_keep_best_preserves_latest_for_crash_resume(tmp_path):
    """With best retention full, metric-less saves newer than every best
    one keep the newest: a crash resumes from it, not from the best."""
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2,
                        keep_best_metric="accuracy", best_mode="max")
    for s, acc in [(1, 0.5), (2, 0.8), (3, 0.95)]:
        ckpt.save(s, _state(s), metrics={"accuracy": acc})
    ckpt.save(10, _state(10.0))
    ckpt.save(20, _state(20.0))
    assert ckpt.best_step() == 3 and ckpt.latest_step() == 20
    restored, step = ckpt.restore_latest(_state(0.0))
    assert step == 20
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  np.full((3, 2), 20.0))
    assert _kept(ckpt.directory) == {2, 3, 20}


class _Toy(NamedTuple):
    w: torch.Tensor
    step: int


def test_fit_eval_hook_feeds_best_checkpointing(tmp_path):
    """fit(eval_every, eval_fn): eval events on cadence, the best state
    (accuracy = -(w-3)^2 peaks at step 3) survives beside the newest."""
    def step_fn(state, batch, seed):
        state.w.add_(1.0)
        return _Toy(state.w, state.step + 1), torch.tensor(0.0), {}

    events = []

    class Rec:
        def emit(self, event, **kw):
            events.append((event, kw))

        def train_step(self, *a, **kw):
            pass

    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=1,
                        keep_best_metric="accuracy", best_mode="max")
    t_loop.fit(step_fn, _Toy(torch.zeros(()), 0), iter(lambda: {}, None), 6,
               rng=0, metrics=Rec(), checkpointer=ckpt, log_every=0,
               eval_every=1,
               eval_fn=lambda s: {"accuracy": -(float(s.w) - 3.0) ** 2})
    assert ckpt.best_step() == 3
    best, step = ckpt.restore_best(_Toy(torch.zeros(()), 0))
    assert step == 3 and float(best.w) == 3.0 and best.step == 3
    latest, lstep = ckpt.restore_latest(_Toy(torch.zeros(()), 0))
    assert lstep == 6 and float(latest.w) == 6.0
    evals = [kw for e, kw in events if e == "eval"]
    assert len(evals) == 6 and evals[2]["accuracy"] == 0.0
    saves = [kw for e, kw in events if e == "checkpoint"]
    assert all(kw["best_tracked"] for kw in saves) and len(saves) == 6


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """async_save copies the state to host memory in save(); a step that
    then updates the tensors in place does not reach the checkpoint."""
    ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2,
                        async_save=True)
    state = {"params": {"w": torch.full((256, 256), 1.0)}, "step": 1}
    assert ckpt.save(1, state)
    state["params"]["w"].add_(1.0)               # the next step, in place
    assert ckpt.latest_step() == 1               # counted while writing
    ckpt.save(2, state)
    state["params"]["w"].add_(1.0)
    ckpt.wait()
    assert ckpt.last_save["bytes"] > 256 * 256 * 4
    for step, want in ((2, 2.0), (1, 1.0)):
        restored, got = Checkpointer(str(tmp_path / "ck")).restore_latest(
            {"params": {"w": torch.zeros(256, 256)}, "step": 0})
        assert got == step
        np.testing.assert_array_equal(restored["params"]["w"].numpy(), want)
        t_ckpt.quarantine_step(ckpt.directory, step, "next")
    ckpt.close()


def _adam_state():
    params = {"w": torch.full((4, 4), 2.5), "b": torch.zeros(4)}
    opt = t_optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    return t_dp.TrainState(params, opt.init(params), 0)


def test_restore_params_skips_optimizer_state(tmp_path):
    """Params only, from the newest step, with no model or optimizer to
    restore into (the inference path)."""
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(5, _adam_state())
    restored, step = Checkpointer(str(tmp_path / "ck")).restore_params()
    assert step == 5 and set(restored) == {"w", "b"}
    np.testing.assert_array_equal(restored["w"].numpy(), 2.5)
    np.testing.assert_array_equal(restored["b"].numpy(), 0.0)


def test_restore_params_empty_returns_none(tmp_path):
    assert Checkpointer(str(tmp_path / "nothing")).restore_params() is None


def test_mismatched_state_raises_and_quarantines_nothing(tmp_path):
    """A state that does not match the checkpoint is the caller's error:
    restore raises and the checkpoint stays in the chain."""
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(1, _state(1.0))
    with pytest.raises(ValueError, match="params/w"):
        ck.restore_latest({"params": {"w": torch.zeros(2, 2)}, "step": 0})
    assert not ck.quarantined and _kept(ck.directory) == {1}


class _RecordingMetrics:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))


def _make_ckpt(directory, metrics=None):
    ck = Checkpointer(str(directory), metrics=metrics)
    for step in (2, 4):
        ck.save(step, {"w": torch.full((64,), float(step))})
    return ck


@pytest.mark.parametrize("mode,marker", [("truncate", "truncated"),
                                         ("corrupt", "corrupt bytes")])
def test_damaged_newest_checkpoint_quarantined_and_older_restored(
        tmp_path, mode, marker):
    """The JAX package's fault injector damages the port's newest step
    (a torn write that changes the size, bitrot that keeps it): restore
    verifies the manifest, quarantines the step with an event, and falls
    back to the previous one."""
    metrics = _RecordingMetrics()
    ck = _make_ckpt(tmp_path / "ck", metrics=metrics)
    assert faults.inject.damage_newest_checkpoint(ck.directory, mode=mode)
    state, step = ck.restore_latest({"w": torch.zeros(64)})
    assert step == 2
    np.testing.assert_array_equal(state["w"].numpy(), np.full(64, 2.0))
    assert ck.quarantined and ck.quarantined[0][0] == 4
    assert marker in ck.quarantined[0][1]
    qdirs = [n for n in os.listdir(ck.directory)
             if n.startswith("quarantined-4")]
    assert len(qdirs) == 1
    qfiles = os.listdir(os.path.join(ck.directory, qdirs[0]))
    assert "manifest.json" in qfiles and "reason.txt" in qfiles
    assert [e for e, _ in metrics.events if e == "ckpt_quarantined"]


def test_all_steps_damaged_restores_none(tmp_path):
    ck = _make_ckpt(tmp_path / "ck")
    faults.inject.damage_newest_checkpoint(ck.directory, mode="truncate")
    with open(os.path.join(ck.directory, "2", "state.pt"), "r+b") as f:
        f.truncate(1)
    assert ck.restore_latest({"w": torch.zeros(64)}) is None
    assert t_ckpt.steps_on_disk(ck.directory) == []
    assert sorted(s for s, _ in ck.quarantined) == [2, 4]


def test_torn_step_without_manifest_is_quarantined_on_load(tmp_path):
    """A step committed but killed before its manifest verifies as OK;
    if its file is torn, the load raises and the chain still moves on."""
    ck = _make_ckpt(tmp_path / "ck")
    os.remove(t_ckpt.manifest_path(ck.directory, 4))
    with open(os.path.join(ck.directory, "4", "state.pt"), "r+b") as f:
        f.truncate(100)
    state, step = ck.restore_latest({"w": torch.zeros(64)})
    assert step == 2 and "restore raised" in ck.quarantined[0][1]


def test_manifest_verify_and_gc(tmp_path):
    d = tmp_path / "ck"
    (d / "3").mkdir(parents=True)
    (d / "3" / "data.bin").write_bytes(b"x" * 1024)
    t_ckpt.write_manifest(str(d), 3)
    assert t_ckpt.verify_manifest(str(d), 3) is None
    (d / "5").mkdir()
    assert t_ckpt.verify_manifest(str(d), 5) is None
    (d / "3" / "data.bin").write_bytes(b"y" * 1024)
    assert "checksum" in t_ckpt.verify_manifest(str(d), 3)
    import shutil
    shutil.rmtree(d / "3")
    t_ckpt.gc_manifests(str(d))
    assert not os.path.exists(t_ckpt.manifest_path(str(d), 3))


def test_jax_control_plane_reads_the_port_directory(tmp_path):
    """The JAX package's ``utils/ckpt.py`` (its ``launch watch`` progress
    probe) reads a torch run's directory unchanged: the same committed
    steps, manifests that verify, and the in-progress tmp dir ignored."""
    ck = _make_ckpt(tmp_path / "ck")
    os.makedirs(os.path.join(ck.directory, "6.tmp-123"))
    assert j_ckpt.latest_step_on_disk(ck.directory) == 4
    assert j_ckpt.steps_on_disk(ck.directory) == \
        t_ckpt.steps_on_disk(ck.directory) == [2, 4]
    for step in (2, 4):
        assert j_ckpt.verify_manifest(ck.directory, step) is None
    with open(os.path.join(ck.directory, "4", "state.pt"), "r+b") as f:
        f.seek(200)
        f.write(b"\xff" * 8)
    assert "checksum" in j_ckpt.verify_manifest(ck.directory, 4)


@pytest.fixture
def world_of_one():
    t_dist.initialize_single("cpu")
    yield
    t_dist.shutdown()


def _mnist_setup(seed=0):
    model = t_mnist.MNISTConvNet(device="cpu", seed=seed)
    opt = t_optim.make_optimizer("adam", 1e-3, grad_clip=None)
    state = t_dp.init_state(dict(model.named_parameters()), opt)
    step = t_dp.make_train_step(
        lambda b, g: t_mnist.loss_fn(model, b, g), opt)
    x, y = t_data.synthetic_mnist(64, seed=0)
    batcher = t_data.ShardedBatcher(x, y, 8, seed=0)
    return model, state, step, batcher.iter_from


def test_restore_writes_into_the_live_tensors(tmp_path, world_of_one):
    """After restore into a fresh model's state, ``state.params[n]`` is
    the model's own parameter, the Adam moments keep their tensors, and
    the model's forward sees the restored values."""
    model, state, step, batches = _mnist_setup()
    state = t_loop.fit(step, state, batches, 2, rng=0)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(2, state)
    x = torch.from_numpy(t_data.synthetic_mnist(4, seed=1)[0])
    want = model(x).detach()

    model2, state2, _, _ = _mnist_setup(seed=1)
    mu = dict(state2.opt_state["mu"])
    restored, step_no = ck.restore_latest(state2)
    assert step_no == 2 and restored.step == 2
    assert restored.opt_state["count"] == 2
    live = dict(model2.named_parameters())
    for n, p in restored.params.items():
        assert p is live[n]
        assert restored.opt_state["mu"][n] is mu[n]
        assert torch.equal(p, state.params[n])
        assert torch.equal(restored.opt_state["nu"][n],
                           state.opt_state["nu"][n])
    assert torch.equal(model2(x).detach(), want)


def test_sigterm_checkpoints_and_stops(tmp_path, world_of_one):
    """A real SIGTERM during step 3 stops the loop at that boundary with
    a save and a ``preempted`` event."""
    _, state, step, batches = _mnist_setup()
    handler = PreemptionHandler.install()
    events = _RecordingMetrics()
    calls = {"n": 0}

    def counting_step(s, b, r):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(s, b, r)

    try:
        ck = Checkpointer(str(tmp_path / "ck"))
        out = t_loop.fit(counting_step, state, batches, num_steps=50, rng=0,
                         metrics=events, checkpointer=ck,
                         checkpoint_every=1000, preemption=handler,
                         log_every=0)
    finally:
        handler.uninstall()
    assert handler.triggered and calls["n"] == 3 and out.step == 3
    assert ck.latest_step() == 3
    pre = [kw for e, kw in events.events if e == "preempted"]
    assert len(pre) == 1 and pre[0]["step"] == 3
    assert pre[0]["checkpointed"] is True and pre[0]["bytes"] > 0


def test_preemption_then_restart_resumes_bitwise(tmp_path, world_of_one):
    """A flag raised after step 3 saves there; a fresh model restarted on
    the directory restores step 3 and ends at step 6 equal to an
    unpreempted run, with a ``restore`` event."""
    _, state, step, batches = _mnist_setup()
    want = t_loop.fit(step, state, batches, 6, rng=0)

    _, state, step, batches = _mnist_setup()
    handler = PreemptionHandler()

    def triggering(s, b, r):
        out = step(s, b, r)
        if out[0].step == 3:
            handler.request()
        return out

    ck = Checkpointer(str(tmp_path / "ck"))
    out = t_loop.fit(triggering, state, batches, 50, rng=0, checkpointer=ck,
                     preemption=handler)
    assert out.step == 3 and ck.latest_step() == 3

    _, state, step, batches = _mnist_setup(seed=5)
    events = _RecordingMetrics()
    got = t_loop.fit(step, state, batches, 6, rng=0, metrics=events,
                     checkpointer=Checkpointer(str(tmp_path / "ck")),
                     log_every=0)
    assert got.step == 6
    assert [kw["step"] for e, kw in events.events if e == "restore"] == [3]
    for n in want.params:
        assert torch.equal(got.params[n], want.params[n]), n
        assert torch.equal(got.opt_state["mu"][n], want.opt_state["mu"][n])


def test_real_sigterm_sets_flag():
    handler = PreemptionHandler.install()
    try:
        assert not handler.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.triggered
    finally:
        handler.uninstall()


def test_agreed_single_process_equals_local_flag(world_of_one):
    h = PreemptionHandler()
    assert h.agreed() is False
    h.request()
    assert h.agreed() is True


def test_agreed_on_two_ranks_latches_every_rank(tmp_path):
    """Only rank 1 is signalled; agreed() is True on both, and latches
    rank 0's local flag."""
    np.savez(tmp_path / "in.npz", dummy=np.zeros(1))
    mp.spawn(torch_dp_worker.run_rank,
             args=(2, t_dist.free_port(), str(tmp_path), "agree"),
             nprocs=2, join=True)
    for r in range(2):
        out = np.load(tmp_path / f"out_{r}.npz")
        assert out["before"].tolist() == [False, False]
        assert out["agreed"].tolist() == [True, True]
        assert bool(out["latched"])


# ---------------------------------------------------------- the MNIST CLI

MNIST = [sys.executable, "-m", "k8s_distributed_deeplearning_torch.train.mnist",
         "--device", "cpu", "--no-eval", "--log-every", "5"]


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=str(REPO))
    env.update(extra)
    return env


def _start(args, tmp_path, name, **env):
    with open(tmp_path / f"{name}.err", "w") as err:   # the child keeps it
        return subprocess.Popen(MNIST + args, stdout=subprocess.PIPE,
                                stderr=err, text=True, cwd=REPO,
                                env=_env(**env))


def _events(lines):
    return [json.loads(line) for line in lines if line.startswith("{")]


def _run_until(proc, event, min_step, sig):
    """Read ``proc``'s events until one named ``event`` at a step >=
    ``min_step``, then send ``sig``; returns every event read."""
    lines = []
    for line in proc.stdout:
        lines.append(line)
        ev = json.loads(line) if line.startswith("{") else {}
        if ev.get("event") == event and ev.get("step", 0) >= min_step:
            proc.send_signal(sig)
            break
    lines += proc.stdout.readlines()
    proc.stdout.close()
    proc.wait(timeout=120)
    return _events(lines)


def _finish(proc):
    out, _ = proc.communicate(timeout=180)
    assert proc.returncode == 0, out
    return _events(out.splitlines())


def _final_state(directory, step):
    return torch.load(Path(directory) / str(step) / "state.pt",
                      weights_only=True)


def _assert_same(a, b):
    assert a["step"] == b["step"]
    assert a["opt_state"]["count"] == b["opt_state"]["count"]
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for m in ("mu", "nu"):
        for n in a["opt_state"][m]:
            assert torch.equal(a["opt_state"][m][n],
                               b["opt_state"][m][n]), (m, n)


def test_cli_sigterm_then_rerun_equals_an_unkilled_run(tmp_path):
    """``--num-steps 60 --checkpoint-every 20``, SIGTERMed after step 20
    and run again: ``preempted`` (checkpointed, exit 0), then ``restore``
    at that step; the step-60 checkpoint holds the unkilled run's params
    and moments bit for bit."""
    common = ["--num-steps", "60", "--checkpoint-every", "20",
              "--batch-size", "16"]
    whole = _start(common + ["--checkpoint-dir", str(tmp_path / "a")],
                   tmp_path, "a")
    killed = _start(common + ["--checkpoint-dir", str(tmp_path / "b")],
                    tmp_path, "b")
    events = _run_until(killed, "train_step", 20, signal.SIGTERM)
    assert killed.returncode == 0
    pre = [e for e in events if e["event"] == "preempted"]
    assert len(pre) == 1 and pre[0]["checkpointed"] is True
    stop = pre[0]["step"]
    assert 20 <= stop < 60 and pre[0]["bytes"] > 0
    rerun = _finish(_start(common + ["--checkpoint-dir", str(tmp_path / "b")],
                           tmp_path, "b2"))
    assert [e["step"] for e in rerun if e["event"] == "restore"] == [stop]
    assert rerun[-1]["event"] == "checkpoint" and rerun[-1]["step"] == 60
    _finish(whole)
    _assert_same(_final_state(tmp_path / "a", 60),
                 _final_state(tmp_path / "b", 60))
    for d in ("a", "b"):
        for step in t_ckpt.steps_on_disk(str(tmp_path / d)):
            assert j_ckpt.verify_manifest(str(tmp_path / d), step) is None


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    return t_data.make_digits_fixture(str(tmp_path_factory.mktemp("digits")))


def _gang(tmp_path, name, digits, dirs):
    port = t_dist.free_port()
    args = ["--num-steps", "60", "--checkpoint-every", "10", "--batch-size",
            "8", "--data-dir", digits]
    return [_start(args + ["--checkpoint-dir", str(dirs[r])], tmp_path,
                   f"{name}{r}", TPUJOB_COORDINATOR_ADDRESS=f"localhost:{port}",
                   TPUJOB_NUM_PROCESSES="2", TPUJOB_PROCESS_ID=str(r))
            for r in range(2)]


def test_cli_two_ranks_sigkilled_after_a_save_resume_bitwise(tmp_path,
                                                             digits):
    """A gang of 2 gloo ranks on the digits fixture (30 steps: the budget
    is divided by the world), SIGKILLed once rank 0 has saved step 10,
    then restarted: it restores on both ranks and ends equal to an
    unkilled gang bit for bit. Each rank is given its own directory; only
    rank 0's is ever written, so the restart's rank 1 takes its state
    from rank 0's broadcast."""
    whole = _gang(tmp_path, "w", digits, [tmp_path / "a0", tmp_path / "a1"])
    dirs = [tmp_path / "b0", tmp_path / "b1"]
    killed = _gang(tmp_path, "k", digits, dirs)
    lines = []
    for line in killed[0].stdout:
        lines.append(line)
        ev = json.loads(line) if line.startswith("{") else {}
        if ev.get("event") == "checkpoint" and ev.get("step", 0) >= 10:
            for p in killed:
                p.kill()
            break
    for p in killed:
        p.stdout.close()
        p.wait(timeout=60)
        assert p.returncode == -signal.SIGKILL
    saved = max(t_ckpt.steps_on_disk(str(dirs[0])))
    assert 10 <= saved < 30
    restart = _gang(tmp_path, "r", digits, dirs)
    events = _finish(restart[0])
    _finish(restart[1])
    restores = [e["step"] for e in events if e["event"] == "restore"]
    assert len(restores) == 1 and restores[0] >= saved
    for p in whole:
        _finish(p)
    _assert_same(_final_state(tmp_path / "a0", 30),
                 _final_state(dirs[0], 30))
    assert not (tmp_path / "a1").exists() and not dirs[1].exists()
