"""PyTorch port, the training loop's observability hooks against the JAX
package's: ``fit``'s spans, events, fault-site firings, heartbeats and
telemetry calls for the same step function and fault plan; the chaos
acceptance test of graftscope (a ``data_wait`` stall on rank 1 attributed
to rank 1's ``data_wait``) on the port's ``fit``; each training fault
site firing as in the JAX package's ``tests/test_faults.py``;
``TrainTelemetry``'s exposition; the step profiler and timer (the JAX
package's ``tests/test_profiling.py`` cases); the calibration dump, read
by both packages; the train CLI's ``--data-path DIR`` and
``--profile-dir`` in a subprocess.

Only times may differ between the packages: every comparison drops the
timing fields (``elapsed_s``, ``dur_ms``, ``step_time_ms``, the
throughputs and the port's save-cost fields). No test gates on a wall
clock; the stall-attribution test uses 0.25 s stalls against a 50 ms
threshold.
"""
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch import faults as t_faults
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.serve import quant as t_quant
from k8s_distributed_deeplearning_torch.telemetry import bridge as t_bridge
from k8s_distributed_deeplearning_torch.telemetry import heartbeat as t_hb
from k8s_distributed_deeplearning_torch.telemetry import timeline
from k8s_distributed_deeplearning_torch.telemetry.registry import (
    MetricsRegistry as TRegistry)
from k8s_distributed_deeplearning_torch.telemetry.trace import (
    Tracer as TTracer)
from k8s_distributed_deeplearning_torch.train import loop as t_loop
from k8s_distributed_deeplearning_torch.train.checkpoint import (
    Checkpointer as TCheckpointer)
from k8s_distributed_deeplearning_torch.train.data import TokenShardBatcher
from k8s_distributed_deeplearning_torch.utils import profiling
from k8s_distributed_deeplearning_torch.utils.metrics import (
    MetricsLogger as TLogger)
from k8s_distributed_deeplearning_tpu import faults as j_faults
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.serve import quant as j_quant
from k8s_distributed_deeplearning_tpu.telemetry import bridge as j_bridge
from k8s_distributed_deeplearning_tpu.telemetry import heartbeat as j_hb
from k8s_distributed_deeplearning_tpu.telemetry.registry import (
    MetricsRegistry as JRegistry)
from k8s_distributed_deeplearning_tpu.telemetry.trace import (
    Tracer as JTracer)
from k8s_distributed_deeplearning_tpu.train import loop as j_loop
from k8s_distributed_deeplearning_tpu.train.checkpoint import (
    Checkpointer as JCheckpointer)
from k8s_distributed_deeplearning_tpu.utils.metrics import (
    MetricsLogger as JLogger)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_plan_leaks():
    t_faults.deactivate()
    j_faults.deactivate()
    yield
    t_faults.deactivate()
    j_faults.deactivate()


# ------------------------------------------- fit's hooks, sequence for sequence

# Event fields that are the same in both packages for a no-op step (the
# rest are times, throughputs or the port's save costs).
_EVENT_KEYS = ("event", "step", "final", "best_tracked", "checkpointed",
               "loss", "entries")


class _Preempt:
    """A preemption handler whose flag is up after ``after`` steps."""

    def __init__(self, after):
        self.after, self.seen = after, 0

    @property
    def triggered(self):
        self.seen += 1
        return self.seen > self.after


def _record_injector(inj, calls):
    fire, suppressed = inj.fire, inj.suppressed

    def rec_fire(site, *, step=None, path=None):
        calls.append(("fire", site, step))
        return fire(site, step=step, path=path)

    def rec_suppressed(site, *, step=None):
        out = suppressed(site, step=step)
        calls.append(("suppressed", site, step, out))
        return out

    inj.fire, inj.suppressed = rec_fire, rec_suppressed


def _hooked_fit(side, tmp_path, preempt_after):
    """One fit per package with every hook on: a no-op step, a fault plan
    (a data_wait stall, a step stall and a heartbeat stop, the sleeps
    recorded rather than slept), periodic, best-metric and final saves
    (or a preemption). Returns what each hook saw."""
    plan = dict(faults=[
        dict(site="data_wait", action="stall", after=1, count=2,
             seconds=0.5),
        dict(site="step", action="stall", step=3, seconds=0.25),
        dict(site="heartbeat", action="stop", step=5)])
    buf, calls, sleeps, beats, tele = io.StringIO(), [], [], [], []
    ckdir = str(tmp_path / side)
    if side == "jax":
        fl, logger, tracer_cls, ck_cls = j_faults, JLogger, JTracer, \
            JCheckpointer
        hb_cls, loop = j_hb.HeartbeatWriter, j_loop
        state, rng = {"w": jnp.zeros((4,), jnp.float32)}, jax.random.key(0)
    else:
        fl, logger, tracer_cls, ck_cls = t_faults, TLogger, TTracer, \
            TCheckpointer
        hb_cls, loop = t_hb.HeartbeatWriter, t_loop
        state, rng = {"w": torch.zeros(4)}, 0
    inj = fl.activate(fl.FaultPlan.from_json(json.dumps(plan)),
                      sleep=sleeps.append)
    _record_injector(inj, calls)

    class _Beats(hb_cls):
        def beat(self, step, last_span=None, **kw):
            beats.append((step, last_span))
            return super().beat(step, last_span=last_span, **kw)

    class _Tele:
        def on_log(self, **kw):
            tele.append(("on_log", kw["steps_in_window"], kw["loss"],
                         kw["mfu"]))

        def on_checkpoint(self):
            tele.append(("on_checkpoint",))

    evals = iter([3.0, 2.0, 2.5, 1.0])
    metrics = logger(stream=buf, job="train")
    ck = ck_cls(ckdir, max_to_keep=5, keep_best_metric="loss",
                best_mode="min")
    try:
        loop.fit(lambda s, batch, r: (s, 0.5, {}), state,
                 lambda start: iter(range(start, 100)), 10, rng,
                 metrics=metrics, checkpointer=ck, checkpoint_every=3,
                 log_every=2, global_batch_size=4,
                 preemption=(_Preempt(preempt_after) if preempt_after
                             else None),
                 eval_every=4, eval_fn=lambda s: {"loss": next(evals)},
                 tracer=tracer_cls(metrics, rank=0),
                 heartbeat=_Beats(str(tmp_path / f"hb-{side}"), 0,
                                  clock=lambda: 100.0),
                 telemetry=_Tele())
    finally:
        ck.close()
        fl.deactivate()
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    spans = [(e["name"], e.get("step")) for e in events
             if e["event"] == "span"]
    others = [{k: e[k] for k in _EVENT_KEYS if k in e} for e in events
              if e["event"] != "span"]
    on_disk = t_hb.read_heartbeats(str(tmp_path / f"hb-{side}"))
    return dict(spans=spans, events=others, calls=calls, sleeps=sleeps,
                beats=beats, telemetry=tele,
                heartbeat_file=[(r["rank"], r["step"], r["last_span"])
                                for r in on_disk])


@pytest.mark.parametrize("preempt_after", [0, 5], ids=["saves", "preempted"])
def test_fit_hooks_equal_jax(preempt_after, tmp_path):
    """Span names and their ``step=``, the events, every fault-site call
    (fired or asked whether suppressed), the stalls, every heartbeat and
    the telemetry calls equal the JAX ``fit``'s, across a periodic save,
    a best-metric save, the final save, and a preemption."""
    got = _hooked_fit("torch", tmp_path, preempt_after)
    want = _hooked_fit("jax", tmp_path, preempt_after)
    for key in got:
        assert got[key] == want[key], key
    names = [n for n, _ in got["spans"]]
    assert names[:2] == ["data_wait", "step"]
    assert got["sleeps"] == [0.5, 0.5, 0.25]
    assert got["beats"][-1][0] == 4          # the stop from step 5 on
    assert got["heartbeat_file"] == [(0, 4, "step")]
    if preempt_after:
        assert got["events"][-1] == {"event": "preempted", "step": 6,
                                     "checkpointed": True}
        assert ("checkpoint", 6) in got["spans"]
    else:
        assert [c[2] for c in got["calls"]
                if c[1] == "checkpoint_saved"] == [3, 6, 9, 10]
        assert ("checkpoint", 4) in got["spans"]      # the best-metric save
        assert got["events"][-1] == {"event": "checkpoint", "step": 10,
                                     "final": True}


def test_chaos_data_stall_attributed_to_injected_rank():
    """graftscope's acceptance test on the port: inject a data_wait stall
    on rank 1 through the port's faults harness, run the port's ``fit``
    per rank, and the readers attribute the slow steps to rank 1's
    data_wait — not to rank 0, not to the step span."""
    plan = t_faults.FaultPlan(faults=(
        t_faults.Fault(site="data_wait", action="stall", rank=1,
                       after=3, count=2, seconds=0.25),))
    logs = {}
    for rank in (0, 1):
        buf = io.StringIO()
        tracer = TTracer(TLogger(stream=buf, job="train"), rank=rank)
        t_faults.activate(plan, rank=rank)
        try:
            t_loop.fit(lambda state, batch, rng: (state, 0.0, {}),
                       state=None, batches=iter(range(8)), num_steps=8,
                       rng=0, tracer=tracer)
        finally:
            t_faults.deactivate()
        logs[rank] = buf.getvalue()
    parsed = timeline.parse_lines(logs[0].splitlines()).merge(
        timeline.parse_lines(logs[1].splitlines()))
    assert parsed.ranks() == [0, 1] and parsed.skipped == 0
    attrs = timeline.attribute_stragglers(
        timeline.build_step_timelines(parsed))
    by_step = {a.step: a for a in attrs}
    for step in (3, 4):
        a = by_step[step]
        assert a.slowest_rank == 1, vars(a)
        assert a.span == "data_wait", vars(a)
        assert a.is_straggler(threshold_ms=50.0, ratio=1.2)
    summary = timeline.straggler_summary(attrs, threshold_ms=50.0,
                                         ratio=1.2)
    assert summary["culprits"].get("rank1:data_wait", 0) >= 2
    assert summary["worst"]["rank"] == 1
    assert summary["worst"]["span"] == "data_wait"


# ------------------------------------------------- the training fault sites


def _tiny_fit(num_steps=6, checkpointer=None, checkpoint_every=0,
              heartbeat=None):
    """A deterministic port ``fit``: a stateless batch schedule and a
    seeded noise term, so two runs agree bit for bit."""

    def step(state, batch, seed):
        w = state["w"]
        g = torch.Generator().manual_seed(seed)
        noise = torch.randn(w.shape, generator=g) * 1e-3
        target = torch.full((4,), 0.01 * batch)
        return ({"w": w - 0.2 * (w - target) + noise},
                ((w - target) ** 2).sum(), {})

    return t_loop.fit(step, {"w": torch.zeros(4)},
                      lambda start: iter(range(start, 10 ** 6)), num_steps,
                      7, log_every=0, checkpointer=checkpointer,
                      checkpoint_every=checkpoint_every, heartbeat=heartbeat)


def test_data_stall_fault_delays_but_never_diverges():
    sleeps = []
    t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
        site="data_wait", action="stall", step=2, seconds=7.5),)),
        sleep=sleeps.append)
    faulted = _tiny_fit()
    t_faults.deactivate()
    clean = _tiny_fit()
    assert sleeps == [7.5]
    assert torch.equal(faulted["w"], clean["w"])


def test_step_fault_fires_before_its_step():
    """``step`` fires before step N's batch is drawn: a stall there is
    taken once, at the named step, and changes nothing trained."""
    sleeps = []
    inj = t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
        site="step", action="stall", step=4, seconds=3.0),)),
        sleep=sleeps.append)
    calls = []
    _record_injector(inj, calls)
    faulted = _tiny_fit()
    t_faults.deactivate()
    assert sleeps == [3.0]
    assert [c[2] for c in calls if c[1] == "step"] == list(range(6))
    order = [c[1] for c in calls if c[0] == "fire"]
    assert order[:4] == ["step", "data_wait", "step", "data_wait"]
    assert torch.equal(faulted["w"], _tiny_fit()["w"])


def test_heartbeat_stop_fault_is_detected_as_stall(tmp_path):
    """The heartbeat writer silenced mid-run: training is unaffected, and
    ``detect_stalls`` on an injected clock names the silent rank."""
    writer = t_hb.HeartbeatWriter(str(tmp_path / "hb"), rank=0,
                                  clock=lambda: 100.0)
    t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
        site="heartbeat", action="stop", step=3),)))
    faulted = _tiny_fit(heartbeat=writer)
    t_faults.deactivate()
    assert torch.equal(faulted["w"], _tiny_fit()["w"])
    recs = t_hb.read_heartbeats(str(tmp_path / "hb"))
    assert len(recs) == 1 and recs[0]["step"] == 2
    stalls = t_hb.detect_stalls(str(tmp_path / "hb"), 5.0, now=200.0)
    assert [s.rank for s in stalls] == [0]
    assert t_hb.detect_stalls(str(tmp_path / "hb"), 5.0, now=102.0) == []


def test_shard_read_transient_ioerror_is_retried(tmp_path, capsys):
    """Two injected shard-read failures cost two backoff sleeps and a
    warning each; the batch equals an unfaulted read. A failure that
    outlasts the retry budget surfaces."""
    np.save(tmp_path / "shard.npy", np.arange(500, dtype=np.int32))
    ref = TokenShardBatcher(str(tmp_path), batch_size=2,
                            seq_len=8).batch_at(0)
    sleeps = []
    t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
        site="shard_read", action="ioerror", count=2),)))
    out = TokenShardBatcher(str(tmp_path), batch_size=2, seq_len=8,
                            io_backoff_s=0.05,
                            sleep=sleeps.append).batch_at(0)
    np.testing.assert_array_equal(out["tokens"], ref["tokens"])
    assert sleeps == [0.05, 0.1]
    assert capsys.readouterr().err.count("shard read failed") == 2
    t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
        site="shard_read", action="ioerror", count=10),)))
    with pytest.raises(OSError, match="injected"):
        TokenShardBatcher(str(tmp_path), batch_size=2, seq_len=8,
                          io_backoff_s=0.01,
                          sleep=lambda _s: None).batch_at(0)


def test_checkpoint_saved_corrupt_falls_back_to_the_previous_save(tmp_path):
    """``checkpoint_saved`` fires once a save is on disk: a ``corrupt``
    there damages the newest step, and the next run's restore quarantines
    it and resumes from the save before, reaching the unfaulted state."""
    t_faults.activate(t_faults.FaultPlan((t_faults.Fault(
        site="checkpoint_saved", action="corrupt", step=4),)))
    ck = TCheckpointer(str(tmp_path / "ck"), max_to_keep=5)
    _tiny_fit(num_steps=4, checkpointer=ck, checkpoint_every=2)
    ck.close()
    t_faults.deactivate()
    metrics_buf = io.StringIO()
    ck = TCheckpointer(str(tmp_path / "ck"), max_to_keep=5,
                       metrics=TLogger(stream=metrics_buf, job="t"))
    state = {"w": torch.zeros(4)}
    restored = ck.restore_latest(state)
    ck.close()
    assert restored is not None and restored[1] == 2
    assert "quarantine" in metrics_buf.getvalue()


# ------------------------------------------------------- TrainTelemetry


@pytest.mark.parametrize("device_stats", [False, True],
                         ids=["probes", "device_bytes"])
def test_train_telemetry_renders_as_jax(device_stats, monkeypatch):
    """The same ``on_log``/``on_checkpoint`` calls render byte for byte
    as JAX's (the live RSS probe pinned on both sides); the device-bytes
    family keeps JAX's name and stat keys."""
    stats = {"bytes_in_use": 5, "peak_bytes_in_use": 7, "bytes_limit": 9}
    for mod in (t_bridge, j_bridge):
        monkeypatch.setattr(mod, "host_rss_bytes", lambda: 123456)
        if device_stats:
            monkeypatch.setattr(mod, "device_memory_stats",
                                lambda: dict(stats))
    out = []
    for bridge, reg_cls in ((t_bridge, TRegistry), (j_bridge, JRegistry)):
        reg = reg_cls()
        tel = bridge.TrainTelemetry(reg, rank=1)
        tel.on_log(steps_in_window=4, loss=2.5, step_time_ms=12.25,
                   examples_per_sec=100.0, mfu=0.3)
        tel.on_checkpoint()
        tel.on_log(steps_in_window=2, loss=2.0, step_time_ms=11.0,
                   examples_per_sec=110.0, mfu=None)
        tel.on_checkpoint()
        out.append(reg.render())
    assert out[0] == out[1]
    assert "train_steps_total 6" in out[0]
    assert "train_checkpoints_total 2" in out[0]
    if device_stats:
        assert 'jax_device_bytes{stat="peak_bytes_in_use"} 7' in out[0]


# ------------------------------------------------------------ the profiler


def test_trace_writes_profile_dir(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.annotate("matmul-span"):
            x = torch.ones((64, 64))
            torch.mm(x, x)
    events = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    assert any(e.get("name") == "matmul-span" for e in events)


def test_trace_disabled_writes_nothing(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d, enabled=False):
        torch.ones((8, 8)) * 2
    assert not os.path.exists(d)


def test_step_profiler_window(tmp_path):
    """The window opens at ``start_step`` and closes ``num_steps`` later:
    only those steps' annotations are in the trace."""
    d = str(tmp_path / "prof")
    p = profiling.StepProfiler(d, start_step=2, num_steps=2)
    for step in range(6):
        p.step_hook(step)
        with profiling.annotate(f"work-{step}"):
            torch.ones((8, 8)) + step
    p.stop()   # idempotent
    events = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"work-2", "work-3"} <= names
    assert not names & {"work-0", "work-1", "work-4", "work-5"}


def test_step_timer_statistics():
    t = profiling.StepTimer(warmup=1)
    for i in range(5):
        t.observe(torch.ones((4,)) * i)
    s = t.summary()
    assert s["steps"] == 4
    assert 0 < s["p50_ms"] <= s["max_ms"]
    assert s["min_ms"] <= s["mean_ms"] <= s["max_ms"]
    assert profiling.StepTimer().summary() == {"steps": 0}


def test_step_profiler_starts_on_resumed_run(tmp_path):
    """A run restored past start_step still captures a window (>= latch),
    and a later window does not restart the trace."""
    d = str(tmp_path / "prof_resume")
    p = profiling.StepProfiler(d, start_step=10, num_steps=2)
    for step in range(100, 105):
        p.step_hook(step)
        torch.ones((4, 4)) + step
    p.stop()
    assert os.path.exists(os.path.join(d, "trace.json"))
    p.step_hook(200)
    assert not p._active


def test_fit_stops_the_profiler_on_every_return(tmp_path):
    """``fit`` calls ``step_hook`` before every step and ``stop()`` on
    return, preempted or not: a window longer than the run is still
    written."""
    for preempt in (None, _Preempt(3)):
        d = str(tmp_path / f"p{preempt is None}")
        p = profiling.StepProfiler(d, start_step=1, num_steps=50)
        t_loop.fit(lambda s, b, r: (s, 0.0, {}), None, iter(range(10)), 6,
                   0, preemption=preempt, profiler=p)
        assert not p._active and os.path.exists(os.path.join(d,
                                                             "trace.json"))


# ------------------------------------------------------- calibration dump


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_llama.config_tiny(dtype=jnp.float32)
    params = j_llama.LlamaLM(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    tcfg = t_llama.config_tiny(dtype=torch.float32,
                               param_dtype=torch.float32)
    model = t_llama.LlamaLM(tcfg, device="cpu")
    model.load_state_dict(t_convert.from_flax_params(tcfg, params))
    return params, model


def test_calibration_dump_equals_jax_and_each_reads_the_other(tiny,
                                                              tmp_path):
    """The port's dump of converted weights has JAX's keys and values;
    each package's ``load_calibration`` reads the other's dump."""
    params, model = tiny
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    n = t_loop.dump_quant_calibration(model, str(mine))
    assert n == j_loop.dump_quant_calibration(params, str(theirs))
    got = j_quant.load_calibration(str(mine))["weights"]
    want = t_quant.load_calibration(str(theirs))["weights"]
    assert sorted(got) == sorted(want) and len(got) == n == 7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_calibration_dump_round_trip(tiny, tmp_path):
    """JAX's round trip on the port: a dump of the true absmax clips
    nothing, so the calibrated int8 weights and scales equal the
    uncalibrated ones bit for bit; every dumped key is a weight the
    quantizer selects."""
    params, _ = tiny
    tcfg = t_llama.config_tiny(dtype=torch.float32,
                               param_dtype=torch.float32)
    models = []
    for _ in range(2):
        m = t_llama.LlamaLM(tcfg, device="cpu")
        m.load_state_dict(t_convert.from_flax_params(tcfg, params))
        models.append(m)
    path = tmp_path / "calib.json"
    n = t_loop.dump_quant_calibration(models[0], str(path))
    calib = t_quant.load_calibration(str(path))
    assert n == len(calib["weights"]) > 0
    t_quant.quantize_model(models[0])
    t_quant.quantize_model(models[1], calibration=calib)
    for (na, a), (nb, b) in zip(models[0].state_dict().items(),
                                models[1].state_dict().items()):
        assert na == nb and torch.equal(a, b), na
    selected = {t_quant.jax_path_name(name)
                for name, _ in t_quant._quantizable(models[1])}
    assert set(calib["weights"]) == selected


def test_fit_writes_the_dump_on_completion_only(tiny, tmp_path):
    """``fit(quant_calib=...)`` dumps the model's stats and emits
    ``quant_calib`` after a completed run; a preempted run writes none;
    asking for a dump without the model is refused."""
    _, model = tiny
    buf = io.StringIO()
    path = tmp_path / "calib.json"
    t_loop.fit(lambda s, b, r: (s, 0.0, {}), None, iter(range(9)), 3, 0,
               metrics=TLogger(stream=buf, job="t"),
               quant_calib=str(path), model=model)
    ev = [json.loads(x) for x in buf.getvalue().splitlines()][-1]
    assert ev["event"] == "quant_calib" and ev["entries"] == 7
    assert ev["path"] == str(path) and ev["step"] == 3
    assert json.loads(path.read_text())["weights"] == \
        t_quant.calibration_absmax(model)
    cut = tmp_path / "cut.json"
    t_loop.fit(lambda s, b, r: (s, 0.0, {}), None, iter(range(9)), 3, 0,
               preemption=_Preempt(1), quant_calib=str(cut), model=model)
    assert not cut.exists()
    with pytest.raises(ValueError, match="model"):
        t_loop.fit(lambda s, b, r: (s, 0.0, {}), None, iter(range(9)), 3,
                   0, quant_calib=str(cut))


# ------------------------------------------------------------ the train CLI


def test_train_cli_streams_shards_and_profiles(tmp_path):
    """``--data-path DIR`` streams the shards (``start`` says
    ``sharded-streaming`` with the window count), ``--profile-dir``
    writes a trace of steps 10-11, and lion runs with a bf16 moment."""
    from k8s_distributed_deeplearning_torch.train import data as t_data
    tokens = t_data.synthetic_tokens(40000, vocab_size=256, seed=1)
    t_data.write_token_shards(tokens, str(tmp_path / "shards"),
                              shard_tokens=16000, dtype="uint8")
    cmd = [sys.executable, "-m", "k8s_distributed_deeplearning_torch.train",
           "--preset", "tiny", "--device", "cpu",
           "--data-path", str(tmp_path / "shards"),
           "--profile-dir", str(tmp_path / "prof"), "--num-steps", "12",
           "--batch-size", "4", "--seq-len", "32", "--log-every", "4",
           "--checkpoint-dir", str(tmp_path / "ck"),
           "--optimizer", "lion", "--moment-dtype", "bfloat16"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    events = [json.loads(x) for x in proc.stdout.splitlines()
              if x.startswith("{")]
    start = next(e for e in events if e["event"] == "start")
    assert start["data"] == "sharded-streaming"
    # Shards of 16000, 16000 and 8000 tokens; a tenth of the last is held
    # out; the rest is cut into 32-token windows.
    assert start["num_windows"] == 2 * (15999 // 32) + (8000 - 800 - 1) // 32
    assert [e["step"] for e in events if e["event"] == "train_step"] == \
        [4, 8, 12]
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]


def test_train_cli_refuses_pack_over_shards(tmp_path):
    from k8s_distributed_deeplearning_torch.train import cli
    from k8s_distributed_deeplearning_torch.train import data as t_data
    t_data.write_token_shards(
        t_data.synthetic_tokens(4000, vocab_size=256, seed=1),
        str(tmp_path), dtype="uint8")
    with pytest.raises(ValueError, match="--pack needs an in-memory"):
        cli.main(["--preset", "tiny", "--device", "cpu", "--data-path",
                  str(tmp_path), "--pack", "--num-steps", "1",
                  "--checkpoint-dir", str(tmp_path / "ck")])
