"""Job manifest renderer: the MPI Operator + MPIJob CRD replacement, for
GPU nodes.

The port's own copy of ``k8s_distributed_deeplearning_tpu/launch/
render.py``. What the reference needs an operator *for*
(``deploy_stack.sh:38``, ``tensorflow-mnist.yaml``): gang-schedule 1
launcher + N workers, wire an SSH control channel, and have the launcher
mpirun into every worker. Here every worker is identical, the control
channel is ``torch.distributed`` (NCCL between cards, gloo on CPUs) with
process 0 as its rendezvous, and gang semantics come from a K8s **Indexed
Job** + headless Service: pod index 0 is the rendezvous, stable DNS names
replace the hostfile, and env vars replace ``mpirun -x``. The whole
operator collapses into a renderer.

Every document and field is the JAX package's, with these substitutions:
the pods request ``nvidia.com/gpu`` (``JobConfig.gpus_per_worker``) in
place of ``google.com/tpu``; the engine-carrying pods select nodes by
``cloud.google.com/gke-accelerator`` (``JobConfig.gpu_accelerator``) in
place of the TPU accelerator and topology labels; the ``framework`` label
is ``k8s-distributed-deeplearning-torch``; serving pods run ``python -m
k8s_distributed_deeplearning_torch.launch serve``. The ``TPUJOB_*`` env
names stay: they are the contract the port's workers read
(``parallel/distributed.py``, ``faults/inject.py``).

Capability parity map:
- ``mpiReplicaSpecs.Worker.replicas`` (``tensorflow-mnist.yaml:44``)  -> Job completions/parallelism
- SSH Secret + hostfile                                   -> headless Service DNS
- ``mpirun -np N`` rank assignment                        -> JOB_COMPLETION_INDEX -> TPUJOB_PROCESS_ID
- ``cleanPodPolicy: Running`` (``tensorflow-mnist.yaml:8``)   -> Job ttlSecondsAfterFinished + restartPolicy
- resource limits (``tensorflow-mnist.yaml:39-53``)           -> container resources + nvidia.com/gpu
"""
from __future__ import annotations

import yaml

from k8s_distributed_deeplearning_torch.config import JobConfig


def _node_selector(cfg: JobConfig) -> dict:
    # GKE labels GPU nodes with their card type; the engine-carrying pods
    # land only on nodes with the requested card.
    return {"cloud.google.com/gke-accelerator": cfg.gpu_accelerator}


def _coordinator_host(cfg: JobConfig) -> str:
    # Indexed-Job pods get hostname <job>-<index> in the headless service's
    # subdomain; index 0 is process 0 (the process group's rendezvous).
    return f"{cfg.name}-0.{cfg.name}.{cfg.namespace}"


def render_namespace(cfg: JobConfig) -> dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": cfg.namespace}}


def render_service(cfg: JobConfig) -> dict:
    """Headless service giving workers stable DNS — the hostfile replacement."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": cfg.name, "namespace": cfg.namespace,
                     "labels": {"app": cfg.name}},
        "spec": {
            "clusterIP": "None",
            "selector": {"job-name": cfg.name},
            "ports": [{"name": "coordinator", "port": cfg.coordinator_port}],
        },
    }


def render_tpujob(cfg: JobConfig) -> dict:
    """The Indexed Job running one identical worker per pod."""
    env = [
        {"name": "TPUJOB_COORDINATOR_ADDRESS",
         "value": f"{_coordinator_host(cfg)}:{cfg.coordinator_port}"},
        {"name": "TPUJOB_NUM_PROCESSES", "value": str(cfg.num_workers)},
        {"name": "TPUJOB_PROCESS_ID",
         "valueFrom": {"fieldRef": {"fieldPath":
             "metadata.annotations['batch.kubernetes.io/job-completion-index']"}}},
        # Visibility for logs/metrics labels
        {"name": "TPUJOB_NAME", "value": cfg.name},
        # Where the in-process telemetry exporter should bind (matches the
        # prometheus.io/port scrape annotation below).
        {"name": "TPUJOB_METRICS_PORT", "value": str(cfg.metrics_port)},
    ]
    if cfg.fault_plan:
        # Chaos-test runs carry their fault plan in the manifest itself,
        # so the rendered object fully describes the experiment.
        env.append({"name": "TPUJOB_FAULT_PLAN", "value": cfg.fault_plan})
    if cfg.tenants:
        # Serving jobs carry their tenant/SLO config the same way — the
        # manifest fully describes the scheduling policy under test.
        env.append({"name": "TPUJOB_TENANTS", "value": cfg.tenants})
    if cfg.fleet_endpoints:
        # Fleet federation targets for the watcher/aggregator sidecar:
        # which replica /metrics endpoints to scrape and health-score.
        env.append({"name": "TPUJOB_FLEET_ENDPOINTS",
                    "value": cfg.fleet_endpoints})
    # Speculative decoding for serving workers: draft preset + per-slot
    # draft count (serve/cli.py --draft-model/--spec-k). Each half
    # renders independently so a dangling one is VISIBLE in the manifest
    # — validate.py enforces the pairing and integer domain offline.
    if cfg.draft_model is not None:
        env.append({"name": "TPUJOB_DRAFT_MODEL", "value": cfg.draft_model})
    if cfg.spec_k is not None:
        env.append({"name": "TPUJOB_SPEC_K", "value": str(cfg.spec_k)})
    # Flight recorder for serving workers (serve/cli.py --flight-ring/
    # --flight-dir): each half renders independently so a dangling dir
    # is VISIBLE in the manifest — validate.py flags it offline.
    if cfg.flight_ring is not None:
        env.append({"name": "TPUJOB_FLIGHT_RING",
                    "value": str(cfg.flight_ring)})
    if cfg.flight_dir is not None:
        env.append({"name": "TPUJOB_FLIGHT_DIR", "value": cfg.flight_dir})
    container = {
        "name": "worker",
        "image": cfg.image,
        "command": ["python", cfg.script, *cfg.script_args],
        "env": env,
        "ports": [{"containerPort": cfg.coordinator_port},
                  {"containerPort": cfg.metrics_port, "name": "metrics"}],
        "resources": {
            "requests": {"cpu": cfg.cpu, "memory": cfg.memory},
            "limits": {"cpu": cfg.cpu, "memory": cfg.memory,
                       "nvidia.com/gpu": str(cfg.chips_per_worker())},
        },
    }
    if cfg.pre_stop_sleep_s:
        # Hold SIGTERM back while the routing layer (Service endpoints /
        # the serving gateway) notices the pod leaving the ready set —
        # otherwise new requests race the drain and get shed instead of
        # served. After the sleep, kubelet delivers SIGTERM and the
        # worker's drain handshake (serve/cli.py) runs inside the
        # remaining terminationGracePeriodSeconds.
        container["lifecycle"] = {
            "preStop": {"exec": {"command":
                ["/bin/sh", "-c", f"sleep {int(cfg.pre_stop_sleep_s)}"]}}}
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": cfg.name, "namespace": cfg.namespace,
                     "labels": {"app": cfg.name, "framework":
                                "k8s-distributed-deeplearning-torch"}},
        "spec": {
            "completions": cfg.num_workers,
            "parallelism": cfg.num_workers,          # gang: all pods at once
            "completionMode": "Indexed",
            "backoffLimit": 3,
            # cleanPodPolicy analog (tensorflow-mnist.yaml:8): "Running" (or
            # "All") reaps finished pods via TTL; "None" keeps them around for
            # post-mortem log inspection.
            **({"ttlSecondsAfterFinished": 600}
               if cfg.clean_pod_policy != "None" else {}),
            "template": {
                "metadata": {
                    "labels": {"app": cfg.name},
                    # Prometheus discovers worker /metrics endpoints via the
                    # standard scrape annotations (the pull plane; Promtail
                    # keeps owning stdout JSONL — telemetry/ serves both).
                    "annotations": {
                        "prometheus.io/scrape": "true",
                        "prometheus.io/port": str(cfg.metrics_port),
                        "prometheus.io/path": "/metrics",
                    },
                },
                "spec": {
                    "subdomain": cfg.name,           # joins the headless svc
                    "restartPolicy": "OnFailure",
                    # SIGTERM→SIGKILL window for the drain / preemption-
                    # checkpoint handshake; must cover the preStop sleep
                    # PLUS the worst-case drain (validate.py checks the
                    # ordering). Omitted = k8s default (30s).
                    **({"terminationGracePeriodSeconds":
                        int(cfg.termination_grace_s)}
                       if cfg.termination_grace_s is not None else {}),
                    "nodeSelector": _node_selector(cfg),
                    "containers": [container],
                },
            },
        },
    }


def _serving_probes(cfg: JobConfig) -> dict:
    """Probe pair shared by both serving roles. Liveness and readiness are
    deliberately DIFFERENT endpoints: /healthz stays 200 through a drain
    (the process is healthy, it is finishing work — restarting it would
    lose the very requests the drain protects), while /readyz flips 503
    the moment drain starts so the routing layer stops sending new work
    before the handshake races it."""
    return {
        "readinessProbe": {
            "httpGet": {"path": "/readyz", "port": cfg.metrics_port},
            "periodSeconds": 2, "failureThreshold": 1,
        },
        "livenessProbe": {
            "httpGet": {"path": "/healthz", "port": cfg.metrics_port},
            "periodSeconds": 10, "failureThreshold": 3,
        },
    }


def _serving_chips(cfg: JobConfig) -> int:
    # Each serving replica is its own pod: it claims gpus_per_worker cards
    # (no num_workers split — that divisor belongs to the training gang,
    # not the serving fleet). A tensor-parallel replica (serve_tp) claims
    # exactly its tp width: its serve process is rank 0 and starts one
    # follower process a further card (serve/tp.py).
    if cfg.serve_tp is not None:
        return cfg.serve_tp
    return cfg.gpus_per_worker


def _serving_env(cfg: JobConfig) -> list[dict]:
    env = [
        {"name": "TPUJOB_NAME", "value": cfg.name},
        {"name": "TPUJOB_METRICS_PORT", "value": str(cfg.metrics_port)},
    ]
    if cfg.fault_plan:
        env.append({"name": "TPUJOB_FAULT_PLAN", "value": cfg.fault_plan})
    if cfg.tenants:
        env.append({"name": "TPUJOB_TENANTS", "value": cfg.tenants})
    if cfg.serve_tp is not None:
        env.append({"name": "TPUJOB_SERVE_TP", "value": str(cfg.serve_tp)})
    # Quantized serving (graftquant, serve/cli.py --kv-quant/
    # --weight-quant): every serving role carries the same modes — disagg
    # roles MUST agree on kv_quant (pages ship as raw arena values and
    # the importer adopts them bit-identically), and a mixed fleet would
    # serve different numerics per replica. validate.py checks the mode
    # names and the quantized pool-byte fit offline.
    if cfg.kv_quant is not None:
        env.append({"name": "TPUJOB_KV_QUANT", "value": cfg.kv_quant})
    if cfg.weight_quant is not None:
        env.append({"name": "TPUJOB_WEIGHT_QUANT",
                    "value": cfg.weight_quant})
    # Elastic serving (serve/autoscale.py): each knob renders
    # independently so a dangling half (min without max, an unknown
    # brownout stage) is VISIBLE in the manifest — validate.py flags it
    # offline, before anything is applied to a cluster.
    if cfg.autoscale_min is not None:
        env.append({"name": "TPUJOB_AUTOSCALE_MIN",
                    "value": str(cfg.autoscale_min)})
    if cfg.autoscale_max is not None:
        env.append({"name": "TPUJOB_AUTOSCALE_MAX",
                    "value": str(cfg.autoscale_max)})
    if cfg.autoscale_up_cooldown_s is not None:
        env.append({"name": "TPUJOB_AUTOSCALE_UP_COOLDOWN_S",
                    "value": str(cfg.autoscale_up_cooldown_s)})
    if cfg.autoscale_down_cooldown_s is not None:
        env.append({"name": "TPUJOB_AUTOSCALE_DOWN_COOLDOWN_S",
                    "value": str(cfg.autoscale_down_cooldown_s)})
    if cfg.autoscale_brownout is not None:
        env.append({"name": "TPUJOB_AUTOSCALE_BROWNOUT",
                    "value": cfg.autoscale_brownout})
    return env


def _serving_pod(cfg: JobConfig, *, role: str, container: dict,
                 subdomain: str) -> dict:
    tmpl: dict = {
        "metadata": {
            "labels": {"app": cfg.name, "role": role},
            "annotations": {
                "prometheus.io/scrape": "true",
                "prometheus.io/port": str(cfg.metrics_port),
                "prometheus.io/path": "/metrics",
            },
        },
        "spec": {
            "subdomain": subdomain,
            "restartPolicy": "OnFailure",
            **({"terminationGracePeriodSeconds":
                int(cfg.termination_grace_s)}
               if cfg.termination_grace_s is not None else {}),
            "containers": [container],
        },
    }
    if role in ("serve-replica", "serve-prefill", "serve-storm"):
        # Engine-carrying tiers run on GPU nodes; only the gateway/
        # coordinator pod is pure CPU dispatch. The storm pod carries
        # its whole in-process fleet, so it claims cards too.
        tmpl["spec"]["nodeSelector"] = _node_selector(cfg)
    return tmpl


def _serving_job(cfg: JobConfig, *, name: str, role: str, replicas: int,
                 container: dict, subdomain: str) -> dict:
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "namespace": cfg.namespace,
                     "labels": {"app": cfg.name, "role": role,
                                "framework":
                                "k8s-distributed-deeplearning-torch"}},
        "spec": {
            "completions": replicas,
            "parallelism": replicas,
            "completionMode": "Indexed",   # stable per-pod DNS identity
            "backoffLimit": 3,
            **({"ttlSecondsAfterFinished": 600}
               if cfg.clean_pod_policy != "None" else {}),
            "template": _serving_pod(cfg, role=role, container=container,
                                     subdomain=subdomain),
        },
    }


def _tier_name(cfg: JobConfig, serve_role: str) -> str:
    return f"{cfg.name}-replica" if serve_role == "decode" \
        else f"{cfg.name}-prefill"


def _replica_server_service(cfg: JobConfig, *, serve_role: str) -> dict:
    name = _tier_name(cfg, serve_role)
    k8s_role = ("serve-replica" if serve_role == "decode"
                else "serve-prefill")
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "namespace": cfg.namespace,
                     "labels": {"app": cfg.name, "role": k8s_role}},
        "spec": {
            "clusterIP": "None",
            "selector": {"job-name": name},
            "ports": [{"name": "metrics", "port": cfg.metrics_port}],
        },
    }


def render_replica_service(cfg: JobConfig) -> dict:
    """Headless service giving replica-server pods stable DNS — the
    gateway's ``--replica-endpoints`` list is rendered against these
    names, so no discovery sidecar is needed in the static topology."""
    return _replica_server_service(cfg, serve_role="decode")


def render_prefill_service(cfg: JobConfig) -> dict:
    """Headless service for the prefill tier (serve/disagg.py): the
    coordinator's ``--prefill-endpoints`` list renders against these
    stable pod DNS names."""
    return _replica_server_service(cfg, serve_role="prefill")


def _replica_server_job(cfg: JobConfig, *, serve_role: str,
                        replicas: int) -> dict:
    name = _tier_name(cfg, serve_role)
    k8s_role = ("serve-replica" if serve_role == "decode"
                else "serve-prefill")
    serve = (f"exec python -m k8s_distributed_deeplearning_torch.launch serve"
             f" --replica-server --preset {cfg.serve_preset}"
             f" --metrics-port {cfg.metrics_port}"
             f" --replica-rank ${{JOB_COMPLETION_INDEX}}"
             f" --advertise-host $(hostname -f)")
    if serve_role != "decode":
        serve += f" --role {serve_role}"
    if cfg.serve_slots is not None:
        serve += f" --slots {cfg.serve_slots}"
    if cfg.serve_tp is not None:
        serve += f" --tp {cfg.serve_tp}"
    if cfg.tenants:
        serve += f" --tenants '{cfg.tenants}'"
    if cfg.flight_ring is not None:
        serve += f" --flight-ring {cfg.flight_ring}"
    if cfg.flight_dir is not None:
        serve += f" --flight-dir {cfg.flight_dir}"
    container = {
        "name": "replica" if serve_role == "decode" else "prefill",
        "image": cfg.image,
        "command": ["/bin/sh", "-c", serve],
        "env": _serving_env(cfg),
        "ports": [{"containerPort": cfg.metrics_port, "name": "metrics"}],
        "resources": {
            "requests": {"cpu": cfg.cpu, "memory": cfg.memory},
            "limits": {"cpu": cfg.cpu, "memory": cfg.memory,
                       "nvidia.com/gpu": str(_serving_chips(cfg))},
        },
        **_serving_probes(cfg),
    }
    if cfg.pre_stop_sleep_s:
        # Same rolling-update race as the training worker: hold SIGTERM
        # until the gateway/Service observes /readyz going 503 and stops
        # routing new requests at this replica.
        container["lifecycle"] = {
            "preStop": {"exec": {"command":
                ["/bin/sh", "-c", f"sleep {int(cfg.pre_stop_sleep_s)}"]}}}
    return _serving_job(cfg, name=name, role=k8s_role,
                        replicas=replicas, container=container,
                        subdomain=name)


def render_replica_job(cfg: JobConfig) -> dict:
    """Replica-server role: one engine per pod behind the transport
    endpoints (serve/cli.py --replica-server). The completion index is
    the replica rank, so the command goes through the shell to splice
    $JOB_COMPLETION_INDEX in."""
    return _replica_server_job(cfg, serve_role="decode",
                               replicas=int(cfg.serve_replicas or 1))


def render_prefill_job(cfg: JobConfig) -> dict:
    """Prefill-worker role (serve/disagg.py): identical replica-server
    pods started with ``--role prefill`` — admission + prefill only,
    finished KV pages exported over /exports for the coordinator to ship
    to the decode tier. The role rides the heartbeat beacon, so decode
    discovery never adopts these pods."""
    return _replica_server_job(
        cfg, serve_role="prefill",
        replicas=int(cfg.serve_prefill_replicas or 1))


def _tier_endpoints(cfg: JobConfig, serve_role: str,
                    replicas: int) -> list[str]:
    name = _tier_name(cfg, serve_role)
    return [f"{name}-{i}.{name}.{cfg.namespace}:{cfg.metrics_port}"
            for i in range(replicas)]


def gateway_replica_endpoints(cfg: JobConfig) -> list[str]:
    """The host:port each replica-server answers on, via Indexed-Job pod
    DNS through the replica headless Service."""
    return _tier_endpoints(cfg, "decode", int(cfg.serve_replicas or 1))


def gateway_prefill_endpoints(cfg: JobConfig) -> list[str]:
    """The host:port each prefill worker answers on — the coordinator's
    ``--prefill-endpoints`` value."""
    return _tier_endpoints(cfg, "prefill",
                           int(cfg.serve_prefill_replicas or 1))


def render_gateway_job(cfg: JobConfig) -> dict:
    """Gateway role: a single CPU-only pod running the failover gateway
    over the remote replica fleet (serve/cli.py --replica-endpoints)."""
    name = f"{cfg.name}-gateway"
    command = ["python", "-m", "k8s_distributed_deeplearning_torch.launch",
               "serve",
               "--replica-endpoints", ",".join(gateway_replica_endpoints(cfg)),
               "--metrics-port", str(cfg.metrics_port)]
    if cfg.serve_prefill_replicas:
        # Disaggregated topology: the gateway pod runs the disagg
        # coordinator over the static prefill tier instead of the plain
        # failover gateway (serve/cli.py --disagg). Mutually exclusive
        # with the elastic gateway — validate.py flags the combination.
        command += ["--disagg", "--prefill-endpoints",
                    ",".join(gateway_prefill_endpoints(cfg))]
    if cfg.autoscale_max is not None:
        # Elastic gateway: the fleet controller runs in this pod and
        # patches the replica Job's parallelism through kubectl
        # (serve/autoscale.py K8sParallelismBackend).
        rep = f"{cfg.name}-replica"
        command += ["--autoscale",
                    "--autoscale-min", str(cfg.autoscale_min or 1),
                    "--autoscale-max", str(cfg.autoscale_max),
                    "--autoscale-k8s-job", rep,
                    "--autoscale-k8s-namespace", cfg.namespace,
                    "--autoscale-endpoint-template",
                    f"{rep}-{{i}}.{rep}.{cfg.namespace}"
                    f":{cfg.metrics_port}"]
        if cfg.autoscale_up_cooldown_s is not None:
            command += ["--autoscale-up-cooldown-s",
                        str(cfg.autoscale_up_cooldown_s)]
        if cfg.autoscale_down_cooldown_s is not None:
            command += ["--autoscale-down-cooldown-s",
                        str(cfg.autoscale_down_cooldown_s)]
        if cfg.autoscale_brownout is not None:
            command += ["--autoscale-brownout", cfg.autoscale_brownout]
    container = {
        "name": "gateway",
        "image": cfg.image,
        "command": command,
        "env": _serving_env(cfg),
        "ports": [{"containerPort": cfg.metrics_port, "name": "metrics"}],
        # No GPU claim: the gateway is pure HTTP dispatch + health routing.
        "resources": {
            "requests": {"cpu": cfg.cpu, "memory": cfg.memory},
            "limits": {"cpu": cfg.cpu, "memory": cfg.memory},
        },
        **_serving_probes(cfg),
    }
    return _serving_job(cfg, name=name, role="serve-gateway", replicas=1,
                        container=container, subdomain=name)


def render_storm_job(cfg: JobConfig) -> dict:
    """Chaos-soak role (serve/storm.py, graftstorm): ONE pod that runs
    the whole exercise — seeded traffic, seeded fault schedule, the
    in-process replica fleet and the invariant monitor. Determinism is
    the point, so nothing is distributed: no Services, no probes (the
    soak is a batch Job that exits 0 clean / 1 on violation), just the
    GPU claim for the engines it hosts and the metrics port for watching
    a long soak live."""
    name = f"{cfg.name}-storm"
    command = ["python", "-m", "k8s_distributed_deeplearning_torch.launch",
               "storm",
               "--seed", str(cfg.storm_seed or 0),
               "--steps", str(cfg.storm_steps),
               "--replicas", str(cfg.serve_replicas or 2),
               "--preset", cfg.serve_preset,
               "--metrics-port", str(cfg.metrics_port)]
    if cfg.serve_slots is not None:
        command += ["--slots", str(cfg.serve_slots)]
    if cfg.storm_fault_rate is not None:
        lo = min(0.05, float(cfg.storm_fault_rate))
        command += ["--fault-rate", str(lo), str(cfg.storm_fault_rate)]
    if cfg.autoscale_max is not None:
        command += ["--autoscale", "--autoscale-max",
                    str(cfg.autoscale_max)]
    if cfg.serve_prefill_replicas:
        command += ["--prefill", str(cfg.serve_prefill_replicas)]
    if cfg.flight_ring is not None:
        command += ["--flight-ring", str(cfg.flight_ring)]
    if cfg.flight_dir is not None:
        command += ["--flight-dir", cfg.flight_dir]
    container = {
        "name": "storm",
        "image": cfg.image,
        "command": command,
        "env": _serving_env(cfg),
        "ports": [{"containerPort": cfg.metrics_port, "name": "metrics"}],
        "resources": {
            "requests": {"cpu": cfg.cpu, "memory": cfg.memory},
            "limits": {"cpu": cfg.cpu, "memory": cfg.memory,
                       "nvidia.com/gpu": str(_serving_chips(cfg))},
        },
    }
    job = _serving_job(cfg, name=name, role="serve-storm", replicas=1,
                       container=container, subdomain=name)
    # A soak is one deterministic attempt: a retried soak with the same
    # seed would just replay the same violation, so fail fast instead of
    # burning backoffLimit laps on it.
    job["spec"]["backoffLimit"] = 0
    job["spec"]["template"]["spec"]["restartPolicy"] = "Never"
    return job


def render_serving(cfg: JobConfig) -> list[dict]:
    """The remote-serving tier: replica headless Service + replica-server
    Indexed Job + gateway Job, plus — when ``cfg.serve_prefill_replicas``
    is set — the prefill Service/Job pair of the disaggregated topology.
    Appended to :func:`render_all` output when ``cfg.serve_replicas`` is
    set."""
    docs = [render_replica_service(cfg), render_replica_job(cfg)]
    if cfg.serve_prefill_replicas:
        docs += [render_prefill_service(cfg), render_prefill_job(cfg)]
    docs.append(render_gateway_job(cfg))
    return docs


def render_all(cfg: JobConfig) -> list[dict]:
    docs = [render_namespace(cfg), render_service(cfg), render_tpujob(cfg)]
    if cfg.serve_replicas:
        docs.extend(render_serving(cfg))
    if cfg.storm_steps:
        docs.append(render_storm_job(cfg))
    return docs


def to_yaml(docs: list[dict]) -> str:
    return yaml.safe_dump_all(docs, sort_keys=False)
