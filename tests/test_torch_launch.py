"""PyTorch port, the launch layer (``launch/``: render, validate, watch,
elastic, the local executor and the CLI) and ``JobConfig``, against the
JAX package's.

Rendering: the port's ``render_all`` equals JAX's for the same
``JobConfig`` fields once the GPU substitution is applied key by key
(:func:`_to_port`: the ``google.com/tpu`` limit becomes ``nvidia.com/gpu``,
the TPU node selector becomes ``cloud.google.com/gke-accelerator``, and the
image, the script, the ``framework`` label and the serving pods' ``-m``
module become the port's); nothing else may differ. Validation: the
port's ``validate`` returns JAX's error list on every seeded fault of
JAX's ``tests/test_render.py`` and ``tests/test_deploy_smoke.py``, a
``$TPUJOB_SERVE_TP`` manifest included. Watch: on JAX's scripted kubectl
(``tests/test_watch.py``) both packages give the same results, retries and
calls. Elastic and the executor: a 2-worker gloo gang of
``examples/train_mnist_torch.py`` on the scikit-learn digits fixture,
one run whole and one killed through the ``executor`` fault site and
restarted by ``run_elastic``, end with bitwise equal parameters and Adam
moments; the resize policy, the restart budget and ``CrashLoopError`` are
JAX's. The kubectl-gated case skips without kubectl, as in JAX.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import pytest
import torch
import yaml

from k8s_distributed_deeplearning_torch import config as t_config
from k8s_distributed_deeplearning_torch.launch import __main__ as t_main
from k8s_distributed_deeplearning_torch.launch import elastic as t_elastic
from k8s_distributed_deeplearning_torch.launch import (
    local_executor as t_exec)
from k8s_distributed_deeplearning_torch.launch import render as t_render
from k8s_distributed_deeplearning_torch.launch import validate as t_validate
from k8s_distributed_deeplearning_torch.launch import watch as t_watch
from k8s_distributed_deeplearning_torch.train import data as t_data
from k8s_distributed_deeplearning_torch.utils import ckpt as t_ckpt
from k8s_distributed_deeplearning_tpu import config as j_config
from k8s_distributed_deeplearning_tpu.launch import __main__ as j_main
from k8s_distributed_deeplearning_tpu.launch import elastic as j_elastic
from k8s_distributed_deeplearning_tpu.launch import render as j_render
from k8s_distributed_deeplearning_tpu.launch import validate as j_validate
from k8s_distributed_deeplearning_tpu.launch import watch as j_watch

REPO = Path(__file__).resolve().parents[1]
TJob, JJob = t_config.JobConfig, j_config.JobConfig
GPU_FIELDS = {"gpus_per_worker", "gpu_accelerator"}
TPU_FIELDS = {"tpu_topology", "tpu_accelerator", "tpu_chips_per_worker"}


def _cfgs(gpus=1, **kw):
    """The same job for both packages: the JAX side claims *gpus* chips a
    pod (``tpu_chips_per_worker``), the port's *gpus* cards."""
    return (JJob(tpu_chips_per_worker=gpus, **kw),
            TJob(gpus_per_worker=gpus, **kw))


_STRINGS = {
    "examples/train_mnist.py": "examples/train_mnist_torch.py",
    "k8s-distributed-deeplearning-tpu:latest":
        "k8s-distributed-deeplearning-torch:latest",
    "k8s-distributed-deeplearning-tpu": "k8s-distributed-deeplearning-torch",
}


def _to_port(obj, accelerator="nvidia-h100-80gb"):
    """JAX's rendering with the GPU substitution applied, key by key:
    resource key, node selector, image, script, framework label, and the
    serving pods' ``-m`` module."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "google.com/tpu":
                out["nvidia.com/gpu"] = v
            elif k == "nodeSelector":
                assert set(v) == {"cloud.google.com/gke-tpu-accelerator",
                                  "cloud.google.com/gke-tpu-topology"}
                out[k] = {"cloud.google.com/gke-accelerator": accelerator}
            else:
                out[k] = _to_port(v, accelerator)
        return out
    if isinstance(obj, list):
        return [_to_port(x, accelerator) for x in obj]
    if isinstance(obj, str):
        return _STRINGS.get(obj, obj).replace(
            "k8s_distributed_deeplearning_tpu.launch",
            "k8s_distributed_deeplearning_torch.launch")
    return obj


PLAN = json.dumps({"faults": [{"site": "step", "action": "exit", "rank": 0,
                               "step": 100}]})
TENANTS = json.dumps({"tenants": [
    {"id": "chat", "priority": "interactive", "weight": 4,
     "rate_tokens_per_s": 2000, "max_slots": 6},
    {"id": "backfill", "priority": "batch", "max_queue": 32}]})

CONFIGS = {
    "default": {},
    "workers4_args": dict(num_workers=4, name="mnist", namespace="train",
                          script_args=["--num-steps", "100"],
                          coordinator_port=1234, metrics_port=9464),
    "chaos": dict(fault_plan=PLAN, tenants=TENANTS,
                  fleet_endpoints="a:9090,b:9091", clean_pod_policy="None"),
    "spec_flight": dict(draft_model="micro", spec_k=4, flight_ring=64,
                        flight_dir="/var/flight", serve_replicas=2),
    "serving": dict(serve_replicas=3, name="svc", namespace="ns",
                    metrics_port=9200, termination_grace_s=60,
                    pre_stop_sleep_s=5, serve_slots=4),
    "disagg": dict(serve_replicas=2, serve_prefill_replicas=1,
                   kv_quant="int8", weight_quant="int8"),
    "autoscale": dict(serve_replicas=2, autoscale_min=2, autoscale_max=5,
                      autoscale_up_cooldown_s=5,
                      autoscale_down_cooldown_s=30,
                      autoscale_brownout="shed_batch,no_hedge"),
    "storm": dict(storm_steps=100, storm_seed=3, storm_fault_rate=0.3,
                  serve_replicas=2, autoscale_max=3, flight_ring=16),
    "tp": dict(serve_replicas=2, serve_tp=2),
    "small_preset": dict(serve_replicas=1, serve_preset="small",
                         memory="64Gi", cpu="8", gpus=8),
}


def _pair(name):
    kw = dict(CONFIGS[name])
    return _cfgs(kw.pop("gpus", 1), **kw)


# ------------------------------------------------------------ JobConfig


def test_job_config_fields_and_defaults_are_jax_but_the_accelerator():
    t_fields = {f.name: f for f in dataclasses.fields(TJob)}
    j_fields = {f.name: f for f in dataclasses.fields(JJob)}
    assert set(t_fields) == (set(j_fields) - TPU_FIELDS) | GPU_FIELDS
    t_def, j_def = TJob(), JJob()
    for name in set(t_fields) - GPU_FIELDS - {"image", "script"}:
        assert getattr(t_def, name) == getattr(j_def, name), name
    assert (t_def.gpus_per_worker, t_def.gpu_accelerator) == (
        1, "nvidia-h100-80gb")
    assert t_def.image == "k8s-distributed-deeplearning-torch:latest"
    assert t_def.script == "examples/train_mnist_torch.py"
    assert (REPO / t_def.script).is_file()
    assert TJob(gpus_per_worker=4, num_workers=3).chips_per_worker() == 4


def test_launch_cli_flags_are_jax_but_the_gpu_pair(monkeypatch):
    """Every JAX ``launch`` flag is the port's, but ``--tpu-topology`` and
    ``--tpu-accelerator``, which become ``--gpus-per-worker`` and
    ``--gpu-accelerator``; ``run-local`` also takes ``--resize-to``."""
    def flags(main):
        seen = {}

        def capture(self, args=None, namespace=None):
            for sub in self._subparsers._group_actions[0].choices.items():
                seen[sub[0]] = {o for a in sub[1]._actions
                                for o in a.option_strings}
            raise SystemExit(0)
        import argparse
        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            main(["validate"])
        monkeypatch.undo()
        return seen

    t, j = flags(t_main.main), flags(j_main.main)
    assert set(t) == set(j) == {"render", "validate", "run-local", "watch"}
    for cmd in t:
        extra = {"--resize-to"} if cmd == "run-local" else set()
        assert t[cmd] == ((j[cmd] - {"--tpu-topology", "--tpu-accelerator"})
                          | {"--gpus-per-worker", "--gpu-accelerator"}
                          | extra), cmd


# ------------------------------------------------------- render vs JAX


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_all_equals_jax_after_the_gpu_mapping(name):
    jcfg, tcfg = _pair(name)
    jdocs, tdocs = j_render.render_all(jcfg), t_render.render_all(tcfg)
    assert tdocs == _to_port(jdocs)
    text = t_render.to_yaml(tdocs)
    assert "nvidia.com/gpu" in text and "google.com/tpu" not in text
    assert list(yaml.safe_load_all(text)) == tdocs


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_validate_of_each_rendering_equals_jax(name):
    """Clean renderings validate clean in both packages, serve_tp included
    (tensor-parallel serving is ported: no error names ROADMAP.md)."""
    jcfg, tcfg = _pair(name)
    j_errs = j_validate.validate(j_render.render_all(jcfg))
    t_errs = t_validate.validate(t_render.render_all(tcfg))
    assert t_errs == j_errs == []


# ---------------------------------------------------- JAX's render cases


def _job(cfg):
    return t_render.render_tpujob(cfg)


def test_renders_three_docs_and_valid_yaml():
    docs = t_render.render_all(TJob(num_workers=4))
    assert [d["kind"] for d in docs] == ["Namespace", "Service", "Job"]
    assert list(yaml.safe_load_all(t_render.to_yaml(docs))) == docs


def test_gang_scheduling_shape():
    spec = _job(TJob(num_workers=8, name="j", namespace="ns"))["spec"]
    assert spec["completions"] == 8 and spec["parallelism"] == 8
    assert spec["completionMode"] == "Indexed"


def test_coordinator_env_wiring():
    job = _job(TJob(num_workers=2, name="mnist", namespace="ml-ops",
                    coordinator_port=1234))
    env = {e["name"]: e for e in
           job["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["TPUJOB_COORDINATOR_ADDRESS"]["value"] == \
        "mnist-0.mnist.ml-ops:1234"
    assert env["TPUJOB_NUM_PROCESSES"]["value"] == "2"
    assert "job-completion-index" in str(env["TPUJOB_PROCESS_ID"]["valueFrom"])


def test_headless_service_matches_subdomain():
    cfg = TJob(name="abc")
    svc = t_render.render_service(cfg)
    assert svc["spec"]["clusterIP"] == "None"
    assert _job(cfg)["spec"]["template"]["spec"]["subdomain"] == \
        svc["metadata"]["name"]


def test_resources_and_gpu_selector():
    tmpl = _job(TJob(cpu="2", memory="4Gi", gpus_per_worker=2,
                     gpu_accelerator="nvidia-a100-80gb"))["spec"][
        "template"]["spec"]
    res = tmpl["containers"][0]["resources"]
    assert res["requests"] == {"cpu": "2", "memory": "4Gi"}
    assert res["limits"] == {"cpu": "2", "memory": "4Gi",
                             "nvidia.com/gpu": "2"}
    assert tmpl["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-a100-80gb"}


def test_script_args_passthrough():
    job = _job(TJob(script_args=["--num-steps", "100"]))
    cmd = job["spec"]["template"]["spec"]["containers"][0]["command"]
    assert cmd == ["python", "examples/train_mnist_torch.py", "--num-steps",
                   "100"]


def test_cards_per_worker_in_every_engine_pod():
    """Each training worker and each serving/storm pod claims
    ``gpus_per_worker`` cards (JAX: the topology's chips); the gateway
    claims none."""
    docs = t_render.render_all(TJob(gpus_per_worker=4, num_workers=3,
                                    serve_replicas=2, storm_steps=5))
    limits = {(d["metadata"].get("labels") or {}).get("role", "train"):
              d["spec"]["template"]["spec"]["containers"][0]["resources"]
              ["limits"].get("nvidia.com/gpu")
              for d in docs if d["kind"] == "Job"}
    assert limits == {"train": "4", "serve-replica": "4",
                      "serve-gateway": None, "serve-storm": "4"}


def test_prometheus_scrape_wiring():
    tmpl = _job(TJob(num_workers=2, metrics_port=9464))["spec"]["template"]
    ann = tmpl["metadata"]["annotations"]
    assert (ann["prometheus.io/scrape"], ann["prometheus.io/port"],
            ann["prometheus.io/path"]) == ("true", "9464", "/metrics")
    container = tmpl["spec"]["containers"][0]
    ports = {p.get("name"): p["containerPort"] for p in container["ports"]}
    assert ports["metrics"] == 9464
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert env["TPUJOB_METRICS_PORT"] == "9464"


def test_deploy_assets_are_valid():
    """``deploy/gpujob-mnist.yaml`` is the port's rendering of the JAX
    package's ``deploy/tpujob-mnist.yaml`` (its header command), validates
    clean, and ``deploy/Dockerfile.torch`` copies the package with its
    kernel sources."""
    docs = list(yaml.safe_load_all((REPO / "deploy" / "gpujob-mnist.yaml")
                                   .read_text()))
    args = ["--num-steps", "20000", "--dtype", "bfloat16"]
    assert docs == t_render.render_all(TJob(num_workers=2, script_args=args))
    assert t_validate.validate(docs) == []
    jdocs = list(yaml.safe_load_all((REPO / "deploy" / "tpujob-mnist.yaml")
                                    .read_text()))
    # The JAX manifest's pods claim a 2x4 slice's chips over 2 workers
    # (4); the port's claim its default of one card.
    expect = _to_port(jdocs)
    expect[2]["spec"]["template"]["spec"]["containers"][0]["resources"][
        "limits"]["nvidia.com/gpu"] = "1"
    assert docs == expect
    docker = (REPO / "deploy" / "Dockerfile.torch").read_text()
    assert "COPY k8s_distributed_deeplearning_torch/" in docker
    assert (REPO / "k8s_distributed_deeplearning_torch" / "csrc").is_dir()


def test_fault_plan_renders_env_and_validates():
    docs = t_render.render_all(TJob(num_workers=2, fault_plan=PLAN))
    env = {e["name"]: e for e in
           docs[2]["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["TPUJOB_FAULT_PLAN"]["value"] == PLAN
    assert t_validate.validate(docs) == []
    names = {e["name"] for e in t_render.render_all(TJob(num_workers=2))[2][
        "spec"]["template"]["spec"]["containers"][0]["env"]}
    assert "TPUJOB_FAULT_PLAN" not in names
    assert t_validate.validate(t_render.render_all(
        TJob(num_workers=2, fault_plan="@/mnt/plan.json"))) == []


def test_fault_plan_site_without_live_hook_fails_validation(monkeypatch):
    """A registered site whose hook is gone fails validation (narrowed by
    monkeypatch); on the port's real tree every registered site has a
    hook, ``executor`` and ``autoscale_actuate`` included, and the port's
    own scan finds the JAX scan's site set on the JAX tree."""
    from k8s_distributed_deeplearning_torch.faults.plan import SITES
    from k8s_distributed_deeplearning_tpu.analysis import (
        fault_sites_in_tree as j_scan)
    docs = t_render.render_all(TJob(num_workers=2, fault_plan=PLAN))
    monkeypatch.setattr(t_validate, "_HOOKED_SITES",
                        frozenset({"serve_decode"}))
    errs = t_validate.validate(docs)
    assert any("no live hook" in e and "'step'" in e for e in errs)
    monkeypatch.setattr(t_validate, "_HOOKED_SITES", None)
    assert t_validate.validate(docs) == []
    assert set(SITES) == set(t_validate._hooked_sites())
    j_root = str(REPO / "k8s_distributed_deeplearning_tpu")
    assert t_validate.fault_sites_in_tree(j_root) == j_scan(j_root)


def test_tenants_spec_and_flight_render_env():
    docs = t_render.render_all(TJob(num_workers=2, tenants=TENANTS,
                                    draft_model="micro", spec_k=4,
                                    flight_ring=8, flight_dir="/f"))
    env = {e["name"]: e.get("value") for e in
           docs[2]["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert (env["TPUJOB_TENANTS"], env["TPUJOB_DRAFT_MODEL"],
            env["TPUJOB_SPEC_K"], env["TPUJOB_FLIGHT_RING"],
            env["TPUJOB_FLIGHT_DIR"]) == (TENANTS, "micro", "4", "8", "/f")
    assert t_validate.validate(docs) == []


def test_graceful_shutdown_renders_prestop_and_grace():
    docs = t_render.render_all(TJob(num_workers=2, termination_grace_s=120,
                                    pre_stop_sleep_s=10))
    tmpl = docs[2]["spec"]["template"]["spec"]
    assert tmpl["terminationGracePeriodSeconds"] == 120
    assert tmpl["containers"][0]["lifecycle"]["preStop"]["exec"][
        "command"] == ["/bin/sh", "-c", "sleep 10"]
    assert t_validate.validate(docs) == []
    tmpl = t_render.render_all(TJob(num_workers=2))[2]["spec"]["template"][
        "spec"]
    assert "terminationGracePeriodSeconds" not in tmpl
    assert "lifecycle" not in tmpl["containers"][0]


def test_serving_roles_render_and_validate():
    cfg = TJob(serve_replicas=3, name="svc", namespace="ns",
               metrics_port=9200)
    docs = t_render.render_all(cfg)
    assert t_validate.validate(docs) == []
    by_name = {(d["kind"], d["metadata"]["name"]): d for d in docs}
    rep = by_name[("Job", "svc-replica")]
    gw = by_name[("Job", "svc-gateway")]
    assert rep["spec"]["completions"] == 3
    assert gw["spec"]["completions"] == 1
    eps = t_render.gateway_replica_endpoints(cfg)
    assert eps == [f"svc-replica-{i}.svc-replica.ns:9200" for i in range(3)]
    gw_cmd = gw["spec"]["template"]["spec"]["containers"][0]["command"]
    assert gw_cmd[:4] == ["python", "-m",
                          "k8s_distributed_deeplearning_torch.launch",
                          "serve"]
    assert ",".join(eps) in " ".join(gw_cmd)
    rep_cmd = rep["spec"]["template"]["spec"]["containers"][0]["command"][2]
    assert "python -m k8s_distributed_deeplearning_torch.launch serve " \
        "--replica-server" in rep_cmd


def test_autoscale_env_and_gateway_flags_render():
    docs = t_render.render_all(TJob(**CONFIGS["autoscale"], name="svc",
                                    namespace="ns", metrics_port=9200))
    assert t_validate.validate(docs) == []
    gw = next(d for d in docs if d["kind"] == "Job" and
              d["metadata"]["labels"].get("role") == "serve-gateway")
    c = gw["spec"]["template"]["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in c["env"]}
    assert (env["TPUJOB_AUTOSCALE_MIN"], env["TPUJOB_AUTOSCALE_MAX"],
            env["TPUJOB_AUTOSCALE_BROWNOUT"]) == ("2", "5",
                                                  "shed_batch,no_hedge")
    cmd = c["command"]
    assert cmd[cmd.index("--autoscale-k8s-job") + 1] == "svc-replica"
    assert cmd[cmd.index("--autoscale-endpoint-template") + 1] == \
        "svc-replica-{i}.svc-replica.ns:9200"
    # The rendered gateway command parses in the port's serve CLI.
    from k8s_distributed_deeplearning_torch.serve import cli as t_cli
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
        t_cli.main(cmd[4:] + ["--replica-server"])
    assert "--replica-server runs the engine side" in err.getvalue()


def test_storm_job_renders_one_attempt():
    docs = t_render.render_all(TJob(**CONFIGS["storm"]))
    storm = docs[-1]
    assert storm["metadata"]["labels"]["role"] == "serve-storm"
    assert storm["spec"]["backoffLimit"] == 0
    assert storm["spec"]["template"]["spec"]["restartPolicy"] == "Never"
    cmd = storm["spec"]["template"]["spec"]["containers"][0]["command"]
    assert cmd[2:4] == ["k8s_distributed_deeplearning_torch.launch", "storm"]
    assert "--autoscale" in cmd


def test_validate_preset_geometry_is_the_port_presets():
    """The offline pool-byte checks size the pods with the serve CLI's
    presets: the tiny row is ``config_tiny``'s geometry in f32, and the
    table is JAX's."""
    from k8s_distributed_deeplearning_torch.models import llama
    cfg = llama.config_tiny()
    assert t_validate._SERVE_PRESET_GEOM["tiny"] == (
        cfg.n_heads, cfg.n_kv_heads, cfg.dim // cfg.n_heads, cfg.n_layers, 4)
    assert t_validate._SERVE_PRESET_GEOM == j_validate._SERVE_PRESET_GEOM
    assert t_validate._DRAFT_PRESET_GEOM == j_validate._DRAFT_PRESET_GEOM


# ---------------------------------------- validate on seeded faults


def _edit_job(docs, fn, role=None):
    job = next(d for d in docs if d["kind"] == "Job" and
               (d["metadata"].get("labels") or {}).get("role") == role)
    fn(job)
    return docs


def _container(job):
    return job["spec"]["template"]["spec"]["containers"][0]


SEEDED = {
    "bad_name": (dict(name="Bad_Name"), None),
    "bad_quantity": (dict(memory="4GiB"), None),
    "gang_broken": ({}, lambda d: _edit_job(
        d, lambda j: j["spec"].update(completions=3))),
    "num_processes_lies": ({}, lambda d: _edit_job(
        d, lambda j: _container(j)["env"][1].update(value="7"))),
    "subdomain_elsewhere": ({}, lambda d: _edit_job(
        d, lambda j: j["spec"]["template"]["spec"].update(
            subdomain="elsewhere"))),
    "no_service": ({}, lambda d: [x for x in d if x["kind"] != "Service"]),
    "plan_not_json": (dict(fault_plan="{not json"), None),
    "plan_bad_site_action": (dict(fault_plan=json.dumps({"faults": [
        {"site": "heartbeat", "action": "exit"}]})), None),
    "tenants_not_json": (dict(tenants="{not json"), None),
    "tenants_unknown_key": (dict(tenants=json.dumps({"tenants": [
        {"id": "a", "colour": "red"}]})), None),
    "tenants_duplicate": (dict(tenants=json.dumps({"tenants": [
        {"id": "a"}, {"id": "a"}]})), None),
    "tenants_weight": (dict(tenants=json.dumps({"tenants": [
        {"id": "a", "weight": -1}]})), None),
    "draft_unknown": (dict(draft_model="gigantic", spec_k=4), None),
    "spec_k_zero": (dict(draft_model="micro", spec_k=0), None),
    "draft_without_k": (dict(draft_model="micro"), None),
    "prestop_eq_grace": (dict(termination_grace_s=15,
                              pre_stop_sleep_s=15), None),
    "prestop_over_default": (dict(pre_stop_sleep_s=45), None),
    "grace_zero": (dict(termination_grace_s=0), None),
    "flight_dir_no_ring": (dict(flight_dir="/f"), None),
    "fleet_endpoint_bad": (dict(fleet_endpoints="a:1,,ftp://b:2,c"), None),
    "readiness_collapsed": (dict(serve_replicas=3), lambda d: _edit_job(
        d, lambda j: _container(j)["readinessProbe"]["httpGet"].update(
            path="/healthz"), role="serve-replica")),
    "liveness_missing": (dict(serve_replicas=3), lambda d: _edit_job(
        d, lambda j: _container(j).pop("livenessProbe"),
        role="serve-replica")),
    "endpoint_drift": (dict(serve_replicas=3), lambda d: _edit_job(
        d, lambda j: j["spec"].update(completions=2, parallelism=2),
        role="serve-replica")),
    "replica_cluster_ip": (dict(serve_replicas=3), lambda d: [
        x if not (x["kind"] == "Service"
                  and x["metadata"]["name"].endswith("-replica"))
        else {**x, "spec": {**x["spec"], "clusterIP": "10.0.0.7"}}
        for x in d]),
    "no_replica_service": (dict(serve_replicas=3), lambda d: [
        x for x in d if not (x["kind"] == "Service" and
                             x["metadata"]["name"].endswith("-replica"))]),
    "prefill_unrouted": (dict(serve_replicas=2, serve_prefill_replicas=1),
                         lambda d: _edit_job(d, lambda j: _container(j)[
                             "command"].__setitem__(slice(6, None), []),
                             role="serve-gateway")),
    "pool_over_memory": (dict(serve_replicas=1, serve_preset="small",
                              memory="16Mi"), None),
    "quant_pool_over_memory": (dict(serve_replicas=1, serve_preset="small",
                                    kv_quant="int8", memory="16Mi"), None),
    "quant_unknown": (dict(serve_replicas=1), lambda d: _edit_job(
        d, lambda j: _container(j)["env"].append(
            {"name": "TPUJOB_KV_QUANT", "value": "fp4"}),
        role="serve-replica")),
    "autoscale_min_only": (dict(serve_replicas=3, autoscale_min=2), None),
    "autoscale_min_over_max": (dict(serve_replicas=3, autoscale_min=5,
                                    autoscale_max=2), None),
    "autoscale_max_zero": (dict(serve_replicas=3, autoscale_max=0), None),
    "autoscale_cooldown_zero": (dict(serve_replicas=3, autoscale_max=4,
                                     autoscale_up_cooldown_s=0), None),
    "autoscale_brownout_typo": (dict(
        serve_replicas=3, autoscale_max=4,
        autoscale_brownout="shed_batch,warp_speed"), None),
    "disagg_with_autoscale": (dict(serve_replicas=2,
                                   serve_prefill_replicas=1,
                                   autoscale_max=3), None),
    "storm_bad_rate": (dict(storm_steps=10, storm_fault_rate=1.5), None),
    "storm_retries": (dict(storm_steps=10), lambda d: _edit_job(
        d, lambda j: j["spec"].update(backoffLimit=2), role="serve-storm")),
}


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_validate_catches_seeded_fault_as_jax(case):
    """Each fault class JAX's validator catches, the port's catches with
    the same error list."""
    kw, edit = SEEDED[case]
    jcfg, tcfg = _cfgs(**kw)
    jdocs, tdocs = j_render.render_all(jcfg), t_render.render_all(tcfg)
    if edit is not None:
        jdocs, tdocs = edit(jdocs) or jdocs, edit(tdocs) or tdocs
    j_errs, t_errs = j_validate.validate(jdocs), t_validate.validate(tdocs)
    assert t_errs == j_errs and t_errs, case
    with pytest.raises(ValueError, match="validation failed"):
        t_validate.validate_or_raise(tdocs)


# ------------------------------------------------ deploy smoke, the CLI


def test_rendered_manifests_validate_clean():
    for workers in (1, 2, 8):
        docs = t_render.render_all(TJob(num_workers=workers,
                                        gpus_per_worker=8))
        assert t_validate.validate(docs) == [], workers


def test_validate_cli_ok():
    out = subprocess.run(
        [sys.executable, "-m", "k8s_distributed_deeplearning_torch.launch",
         "validate", "--workers", "4", "--serve-replicas", "2"],
        capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "offline validation: OK (6 objects)" in out.stdout


def test_render_cli_prints_gpu_manifests(capsys):
    assert t_main.main(["render", "--workers", "2", "--gpus-per-worker", "2",
                        "--", "--num-steps", "5"]) == 0
    text = capsys.readouterr().out
    docs = list(yaml.safe_load_all(text))
    assert "nvidia.com/gpu: '2'" in text and "google.com/tpu" not in text
    assert docs == t_render.render_all(TJob(
        num_workers=2, gpus_per_worker=2, script_args=["--num-steps", "5"]))


def test_validate_cli_reports_tp_naming_roadmap(capsys):
    """A tp manifest validates clean from the CLI now that the serve CLI
    runs ``--tp``: exit 0, and no error names ROADMAP.md."""
    assert t_main.main(["validate", "--serve-replicas", "1",
                        "--serve-tp", "2"]) == 0
    captured = capsys.readouterr()
    assert "ROADMAP.md" not in captured.err + captured.out


@pytest.mark.skipif(shutil.which("kubectl") is None,
                    reason="kubectl not installed")
def test_kubectl_server_dry_run():
    """Gated: server-side schema validation when a cluster answers."""
    docs = t_render.render_all(TJob(num_workers=2))
    try:
        ok, out = t_validate.kubectl_validate(t_render.to_yaml(docs))
    except Exception as e:  # no cluster behind kubectl
        pytest.skip(f"no reachable cluster: {e}")
    if "connection refused" in out or "Unable to connect" in out:
        pytest.skip("no reachable cluster")
    assert ok, out


def test_run_local_rejects_invalid_manifest():
    said = []
    for run_local, Job in ((t_exec.run_local, TJob),
                           (j_elastic.run_local, JJob)):
        with pytest.raises(ValueError, match="validation failed") as err:
            run_local(Job(num_workers=2, name="Bad_Name"))
        said.append(str(err.value))
    assert said[0] == said[1]


def test_resolve_env_is_kubelet_semantics():
    docs = t_render.render_all(TJob(num_workers=3))
    env = docs[2]["spec"]["template"]["spec"]["containers"][0]["env"]
    out = t_exec._resolve_env(env, 2)
    assert out["TPUJOB_PROCESS_ID"] == "2"
    assert out["TPUJOB_NUM_PROCESSES"] == "3"
    with pytest.raises(NotImplementedError, match="cannot resolve"):
        t_exec._resolve_env([{"name": "X", "valueFrom": {"fieldRef": {
            "fieldPath": "status.podIP"}}}], 0)


# ------------------------------------------------------------ watch


class FakeCluster:
    """Scripted kubectl runner (JAX's ``tests/test_watch.py`` fake):
    serves job_status from a queue of statuses, records every call."""

    def __init__(self, statuses):
        self.statuses = list(statuses)
        self.calls = []

    def runner(self, args, input_text):
        verb = args[0]
        if verb == "apply":
            self.calls.append(("apply", list(yaml.safe_load_all(
                input_text))))
            return 0, "applied", ""
        if verb == "delete":
            self.calls.append(("delete", args[2]))
            return 0, "deleted", ""
        if verb == "get":
            st = (self.statuses.pop(0) if self.statuses
                  else {"succeeded": 0, "active": 0})
            self.calls.append(("get", st))
            if st is None:
                return 1, "", 'jobs.batch "x" not found (NotFound)'
            return 0, json.dumps({"status": st}), ""
        raise AssertionError(f"unexpected kubectl verb {args!r}")


def _watch_both(statuses, num_workers, resize=None, **kw):
    """The same script on both packages' ``watch``: (result, calls,
    events) each, the JAX side's applied documents mapped to the port's."""
    out = []
    for watch, cfg in ((j_watch, JJob(num_workers=num_workers,
                                      tpu_chips_per_worker=1)),
                       (t_watch, TJob(num_workers=num_workers))):
        cluster = FakeCluster(statuses)
        fake = {"t": 0.0}
        events = []
        try:
            res = watch.watch(
                cfg, kubectl=watch.Kubectl(runner=cluster.runner),
                clock=lambda: fake["t"],
                sleep=lambda dt: fake.__setitem__("t", fake["t"] + dt),
                poll_interval=1.0, on_event=events.append,
                resize=watch.resize_to(resize) if resize else None, **kw)
            result = (res.restarts, res.cfg.num_workers,
                      dataclasses.asdict(res.status))
        except RuntimeError as e:
            result = ("raised", str(e))
        calls = [(v, _to_port(d) if v == "apply" and watch is j_watch
                  else d) for v, d in cluster.calls]
        out.append((result, calls, events))
    assert out[1] == out[0]
    return out[1]


def test_watch_completes():
    result, calls, _ = _watch_both([
        {"active": 2, "succeeded": 0}, {"active": 1, "succeeded": 1},
        {"active": 0, "succeeded": 2}], 2, attempt_timeout=100.0)
    assert result[0] == 0 and result[2]["succeeded"] == 2
    assert calls[0][0] == "apply"


def test_watch_reconciles_failed_job_with_resize():
    result, calls, events = _watch_both([
        {"active": 2, "succeeded": 0},
        {"active": 0, "succeeded": 0, "failed": 4,
         "conditions": [{"type": "Failed", "status": "True"}]},
        {"active": 1, "succeeded": 0}, {"active": 0, "succeeded": 1}],
        2, attempt_timeout=100.0, resize=1)
    assert result[:2] == (1, 1)
    applies = [d for v, d in calls if v == "apply"]
    assert len(applies) == 2 and ("delete", "tpu-mnist") in calls
    assert applies[-1][2]["spec"]["completions"] == 1
    assert any("resizing 2 -> 1" in e for e in events)


def test_watch_timeout_counts_as_broken_gang():
    hang = {"active": 2, "succeeded": 0}
    result, _, _ = _watch_both([hang] * 15 + [{"active": 0, "succeeded": 1}],
                               2, attempt_timeout=10.0, resize=1)
    assert result[0] >= 1 and result[1] == 1


def test_watch_exhausts_restarts():
    fail = {"active": 0, "succeeded": 0, "failed": 4,
            "conditions": [{"type": "Failed", "status": "True"}]}
    result, _, _ = _watch_both([fail] * 10, 2, attempt_timeout=100.0,
                               max_restarts=2)
    assert result[0] == "raised" and "failed 3 attempts" in result[1]


def test_watch_missing_job_is_not_complete():
    result, _, _ = _watch_both([None] * 4 + [{"active": 0, "succeeded": 1}],
                               1, attempt_timeout=3.0, max_restarts=1)
    assert result[0] == 1 and result[2]["succeeded"] == 1


class FlakyRunner:
    """Pops one (rc, out, err), or an exception to raise, a call."""

    def __init__(self, script):
        self.script = list(script)
        self.attempts = 0

    def __call__(self, args, input_text):
        self.attempts += 1
        step = self.script.pop(0)
        if isinstance(step, Exception):
            raise step
        return step


def _kubectl_both(script, call, **kw):
    """Run *call(kubectl)* on both packages over the same scripted
    runner: (outcome, attempts, sleeps) equal."""
    out = []
    for watch, Job in ((j_watch, JJob), (t_watch, TJob)):
        runner, sleeps = FlakyRunner(script), []
        k = watch.Kubectl(runner=runner, sleep=sleeps.append,
                          rng=lambda: 1.0, **kw)
        try:
            got = call(k, Job)
        except RuntimeError as e:
            got = ("raised", str(e))
        out.append((got, runner.attempts, sleeps))
    assert out[1] == out[0]
    return out[1]


def test_kubectl_retries_transient_failures_with_backoff():
    got, attempts, sleeps = _kubectl_both([
        (1, "", "Unable to connect to the server: dial tcp: i/o timeout"),
        (1, "", "Unable to connect to the server: connection refused"),
        (0, json.dumps({"status": {"active": 1}}), "")],
        lambda k, Job: dataclasses.asdict(k.job_status(Job(num_workers=1))),
        retries=2, backoff_s=1.0)
    assert got["exists"] and got["active"] == 1
    assert attempts == 3 and sleeps == [1.0, 2.0]


def test_kubectl_retries_raised_timeouts():
    got, attempts, sleeps = _kubectl_both([
        RuntimeError("kubectl get job timed out after 120.0s"),
        (0, json.dumps({"status": {"succeeded": 1}}), "")],
        lambda k, Job: k.job_status(Job(num_workers=1)).succeeded,
        retries=2, backoff_s=0.5)
    assert got == 1 and attempts == 2 and sleeps == [0.5]


def test_kubectl_does_not_retry_permanent_errors():
    got, attempts, sleeps = _kubectl_both(
        [(1, "", 'jobs.batch is forbidden: User "x" cannot get resource')],
        lambda k, Job: k.job_status(Job(num_workers=1)),
        retries=3, backoff_s=1.0)
    assert got[0] == "raised" and "forbidden" in got[1]
    assert attempts == 1 and sleeps == []
    got, attempts, sleeps = _kubectl_both(
        [RuntimeError("kubectl not found on PATH — ...")],
        lambda k, Job: k._run_kubectl(["get", "job", "x"]), retries=3)
    assert got[0] == "raised" and attempts == 1 and sleeps == []


def test_kubectl_retry_budget_is_bounded():
    got, attempts, sleeps = _kubectl_both(
        [(1, "", "connection refused")] * 3,
        lambda k, Job: k._run_kubectl(["get", "job", "x"]),
        retries=2, backoff_s=1.0)
    assert got[0] == 1 and "connection refused" in got[2]
    assert attempts == 3 and sleeps == [1.0, 2.0]
    got, attempts, _ = _kubectl_both(
        [RuntimeError("request timed out")] * 2,
        lambda k, Job: k._run_kubectl(["get", "job", "x"]), retries=1)
    assert got[0] == "raised" and attempts == 2


# -------------------------------------------------- elastic, executor


def test_resize_policy():
    for elastic, Job in ((t_elastic, TJob), (j_elastic, JJob)):
        cfg = Job(num_workers=4)
        new = elastic.resize_to(2)(cfg, [])
        assert new.num_workers == 2 and cfg.num_workers == 4


def _script_cfg(Job, tmp_path, name, body, workers):
    script = tmp_path / name
    script.write_text(textwrap.dedent(body))
    return Job(num_workers=workers, script=str(script), script_args=[])


FLAKY = """
    import json, os, sys
    flag = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "crashed_once")
    if os.environ["TPUJOB_PROCESS_ID"] == "1" and not os.path.exists(flag):
        open(flag, "w").close()
        sys.exit(17)
    print(json.dumps({"event": "worker_ok",
                      "pid": os.environ["TPUJOB_PROCESS_ID"],
                      "world": os.environ["TPUJOB_NUM_PROCESSES"],
                      "attempt": os.environ["TPUJOB_ATTEMPT"]}))
"""


def test_elastic_restarts_crashed_gang(tmp_path):
    seen = []
    cfg = _script_cfg(TJob, tmp_path, "flaky.py", FLAKY, 2)
    res, restarts = t_elastic.run_elastic(
        cfg, cwd=str(REPO), timeout=60,
        on_restart=lambda n, c: seen.append((n, c.num_workers)))
    assert restarts == 1 and seen == [(1, 2)]
    assert [r.returncode for r in res] == [0, 0]
    assert [json.loads(r.stdout)["attempt"] for r in res] == ["1", "1"]


def test_elastic_resize_on_failure(tmp_path):
    body = """
        import json, os, sys
        if os.environ["TPUJOB_NUM_PROCESSES"] != "1" \\
                and os.environ["TPUJOB_PROCESS_ID"] == "1":
            sys.exit(23)
        print(json.dumps({"world": os.environ["TPUJOB_NUM_PROCESSES"]}))
    """
    seen = []
    cfg = _script_cfg(TJob, tmp_path, "small_world.py", body, 2)
    res, restarts = t_elastic.run_elastic(
        cfg, cwd=str(REPO), timeout=60, resize=t_elastic.resize_to(1),
        on_restart=lambda n, c: seen.append((n, c.num_workers)))
    assert restarts == 1 and seen == [(1, 1)]
    assert len(res) == 1 and json.loads(res[0].stdout)["world"] == "1"


def test_elastic_gives_up_after_max_restarts(tmp_path):
    said = []
    for elastic, Job in ((t_elastic, TJob), (j_elastic, JJob)):
        d = tmp_path / Job.__module__.split(".")[0]
        d.mkdir()
        cfg = _script_cfg(Job, d, "fails.py", "import sys; sys.exit(3)\n",
                          1)
        if Job is JJob:
            cfg = dataclasses.replace(cfg, tpu_chips_per_worker=1)
        with pytest.raises(RuntimeError, match="gang failed") as err:
            elastic.run_elastic(cfg, cwd=str(REPO), max_restarts=1,
                                timeout=60)
        said.append(str(err.value).splitlines()[0])
    assert said[0] == said[1] == \
        "gang failed 2 times (last: worker 0 exited 3):"


def test_crash_loop_stops_early_as_jax(tmp_path):
    """Attempts that die without checkpoint progress stop the loop with
    ``CrashLoopError`` (and a ``crash_loop`` event) before the restart
    budget is spent, with JAX's message and exit codes."""
    said = []
    for elastic, Job in ((t_elastic, TJob), (j_elastic, JJob)):
        d = tmp_path / Job.__module__.split(".")[0]
        (d / "ck").mkdir(parents=True)
        cfg = _script_cfg(Job, d, "dies.py", "import sys; sys.exit(5)\n", 1)
        if Job is JJob:
            cfg = dataclasses.replace(cfg, tpu_chips_per_worker=1)
        events = []

        class _Log:
            def emit(self, event, **fields):
                events.append((event, fields))

        with pytest.raises(elastic.CrashLoopError) as err, \
                contextlib.redirect_stderr(io.StringIO()):
            elastic.run_elastic(cfg, cwd=str(REPO), max_restarts=10,
                                timeout=60, checkpoint_dir=str(d / "ck"),
                                crash_loop_after=2, metrics=_Log())
        said.append((str(err.value), err.value.exit_codes, events))
    assert said[0] == said[1]
    assert said[0][1] == [[5], [5]]
    assert said[0][2][0][0] == "crash_loop"


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    return t_data.make_digits_fixture(str(tmp_path_factory.mktemp("digits")))


def _mnist_cfg(ck, digits, workers, num_steps, fault_plan=None):
    return TJob(num_workers=workers, fault_plan=fault_plan, script_args=[
        "--device", "cpu", "--num-steps", str(num_steps), "--batch-size",
        "8", "--no-eval", "--checkpoint-dir", str(ck), "--checkpoint-every",
        "2", "--log-every", "2", "--prefetch", "0", "--data-dir", digits])


CPU_ENV = {"OMP_NUM_THREADS": "1"}


def _events(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


def _assert_same_state(a_dir, b_dir, step):
    a = torch.load(Path(a_dir) / str(step) / "state.pt", weights_only=True)
    b = torch.load(Path(b_dir) / str(step) / "state.pt", weights_only=True)
    assert a["step"] == b["step"] == step
    for n in a["params"]:
        assert torch.equal(a["params"][n], b["params"][n]), n
    for m in ("mu", "nu"):
        for n in a["opt_state"][m]:
            assert torch.equal(a["opt_state"][m][n], b["opt_state"][m][n])


def test_rendered_job_executes_locally_and_survives_an_executor_kill(
        tmp_path, digits):
    """``launch run-local --workers 2`` forms a 2-rank gloo gang from the
    manifest (rank 1 emits nothing), exits 0 on both ranks. The same gang
    with an ``executor`` fault that SIGKILLs rank 0 while it stalls after
    its step-4 checkpoint is restarted by ``run_elastic`` from the newest
    step on disk, and ends with parameters and Adam moments bitwise equal
    to the unkilled gang's."""
    whole, killed = tmp_path / "whole", tmp_path / "killed"
    out = {}

    def unkilled():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out["rc"] = t_main.main(
                ["run-local", "--workers", "2", "--timeout", "240", "--"]
                + _mnist_cfg(whole, digits, 2, 24).script_args)
        out["stdout"] = buf.getvalue()

    old = {k: os.environ.get(k) for k in CPU_ENV}
    os.environ.update(CPU_ENV)
    try:
        th = threading.Thread(target=unkilled)
        th.start()
        plan = json.dumps({"faults": [
            {"site": "step", "action": "stall", "rank": 0, "step": 5,
             "seconds": 120},
            {"site": "executor", "action": "exit", "rank": 0,
             "seconds": 20}]})
        on_disk = []
        with contextlib.redirect_stderr(io.StringIO()):
            res, restarts = t_elastic.run_elastic(
                _mnist_cfg(killed, digits, 2, 24, plan), max_restarts=1,
                timeout=240, cwd=str(REPO), extra_env=CPU_ENV,
                checkpoint_dir=str(killed),
                on_restart=lambda n, c: on_disk.append(
                    t_ckpt.latest_step_on_disk(str(killed))))
        th.join()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert out["rc"] == 0
    ev = _events(out["stdout"])
    start = next(e for e in ev if e["event"] == "start")
    assert start["world_size"] == 2 and start["num_steps"] == 12
    assert sum(e["event"] == "start" for e in ev) == 1   # rank 0 only
    assert restarts == 1 and [r.returncode for r in res] == [0, 0]
    assert on_disk and on_disk[0] >= 2
    restore = [e["step"] for e in _events(res[0].stdout)
               if e["event"] == "restore"]
    assert restore == on_disk
    assert _events(res[1].stdout) == []
    _assert_same_state(whole, killed, 12)


def test_elastic_resize_resumes_from_checkpoint(tmp_path, digits):
    """World resize 2 -> 1 through the rendered-job path: the 1-worker
    gang restores the 2-worker gang's last step instead of starting
    over."""
    ck = tmp_path / "ck"
    res, restarts = t_elastic.run_elastic(
        _mnist_cfg(ck, digits, 2, 8), extra_env=CPU_ENV, cwd=str(REPO),
        timeout=240)
    assert restarts == 0 and len(res) == 2
    res, restarts = t_elastic.run_elastic(
        _mnist_cfg(ck, digits, 1, 8), extra_env=CPU_ENV, cwd=str(REPO),
        timeout=240)
    assert restarts == 0 and len(res) == 1
    ev = _events(res[0].stdout)
    assert [e["step"] for e in ev if e["event"] == "restore"] == [4]
    assert any(e["event"] == "checkpoint" and e["step"] == 8 for e in ev)


def test_graftlint_over_the_port_is_clean():
    """Graftlint over the port finds nothing, no fault site without a
    caller among them (``executor`` and ``autoscale_actuate`` have theirs
    now), and the worker example lints clean alone."""
    from k8s_distributed_deeplearning_tpu import analysis
    assert analysis.run(
        [str(REPO / "k8s_distributed_deeplearning_torch")]).findings == ()
    assert analysis.run(
        [str(REPO / "examples" / "train_mnist_torch.py")]).findings == ()
