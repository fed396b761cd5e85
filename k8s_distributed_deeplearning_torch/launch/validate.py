"""Manifest validation — execution-grade checks without a cluster.

The port's own copy of ``k8s_distributed_deeplearning_tpu/launch/
validate.py``: every check, with the same messages, over the port's
GPU manifests. The reference's only verification of its deploy layer was
deploying it (``deploy_stack.sh:3,31`` — ``set -e`` + ``helm --wait``).
This module gives the rendered manifests three tiers of checking:

1. :func:`validate` — offline structural validation (no cluster, runs in
   CI): K8s object shape, RFC-1123 names, resource-quantity syntax, env
   fieldRef correctness, and the cross-object *contract*: the
   coordinator address must point at completion index 0 through the
   headless Service, TPUJOB_NUM_PROCESSES must equal the Job's
   completions, the Service selector must match the Job's pods.
2. ``kubectl --dry-run`` (:func:`kubectl_validate`) — server-side schema
   validation when a cluster (or kind) is reachable; skipped otherwise.
3. :mod:`launch.local_executor` — actually *runs* the manifest's pod
   template locally, the strongest no-cluster check.

One difference from the JAX package: a fault plan's sites are checked
against this package's own hooks (:func:`fault_sites_in_tree`, a small
AST scan).
"""
from __future__ import annotations

import re
import shutil
import subprocess

from k8s_distributed_deeplearning_torch.faults.plan import FaultPlan

_RFC1123 = re.compile(r"^[a-z0-9]([a-z0-9-]{0,251}[a-z0-9])?$")
# K8s resource.Quantity (the practical subset: plain/decimal-SI/binary-SI).
_QUANTITY = re.compile(r"^[0-9]+(\.[0-9]+)?(m|k|M|G|T|P|Ki|Mi|Gi|Ti|Pi)?$")
_ENV_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_ALLOWED_FIELDREFS = {
    "metadata.name", "metadata.namespace", "metadata.uid", "spec.nodeName",
    "status.podIP", "status.hostIP",
    "metadata.annotations['batch.kubernetes.io/job-completion-index']",
}


def _err(errors: list[str], where: str, msg: str) -> None:
    errors.append(f"{where}: {msg}")


def _check_name(errors, where, name) -> None:
    if not isinstance(name, str) or not _RFC1123.match(name or ""):
        _err(errors, where, f"invalid RFC-1123 name {name!r}")


def _check_container(errors, where: str, c: dict) -> None:
    if not c.get("image"):
        _err(errors, where, "container has no image")
    if not c.get("command") and not c.get("args"):
        _err(errors, where, "container has neither command nor args")
    seen = set()
    for e in c.get("env", []):
        n = e.get("name", "") or ""
        if not _ENV_NAME.match(n):
            _err(errors, where, f"invalid env var name {n!r}")
        if n in seen:
            _err(errors, where, f"duplicate env var {n!r}")
        seen.add(n)
        if ("value" in e) == ("valueFrom" in e):
            _err(errors, where,
                 f"env {n!r} needs exactly one of value/valueFrom")
        ref = (e.get("valueFrom") or {}).get("fieldRef", {}).get("fieldPath")
        if "valueFrom" in e and ref not in _ALLOWED_FIELDREFS:
            _err(errors, where, f"env {n!r} references unknown fieldPath "
                 f"{ref!r}")
    for kind in ("requests", "limits"):
        for res, qty in (c.get("resources", {}).get(kind) or {}).items():
            if not _QUANTITY.match(str(qty)):
                _err(errors, where,
                     f"{kind}.{res} quantity {qty!r} is not a valid "
                     "Kubernetes resource quantity")
    _check_fault_plan(errors, where, c)
    _check_tenants(errors, where, c)
    _check_fleet_endpoints(errors, where, c)
    _check_spec(errors, where, c)
    _check_tp(errors, where, c)
    _check_quant(errors, where, c)
    _check_flight(errors, where, c)
    _check_autoscale(errors, where, c)


def fault_sites_in_tree(root: str | None = None) -> frozenset[str]:
    """Fault-site names with a live hook in the port's tree: the first
    argument of every ``<x>.fire("<site>", ...)`` or ``.suppressed(...)``
    call, and the literal of every ``<x>.site == "<site>"`` comparison
    (the executor's out-of-process hook), outside ``faults/plan.py``
    itself, which only registers them. *root* overrides the scanned
    directory (the package by default)."""
    import ast
    import os

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    registry = os.path.join(root, "faults", "plan.py")
    sites: set[str] = set()
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if not fn.endswith(".py") or path == registry:
                continue
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
            for n in ast.walk(tree):
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in ("fire", "suppressed")
                        and n.args and isinstance(n.args[0], ast.Constant)
                        and isinstance(n.args[0].value, str)):
                    sites.add(n.args[0].value)
                elif (isinstance(n, ast.Compare) and len(n.comparators) == 1
                      and isinstance(n.ops[0], (ast.Eq, ast.NotEq))):
                    sides = (n.left, n.comparators[0])
                    if any(isinstance(s, ast.Attribute) and s.attr == "site"
                           for s in sides):
                        sites.update(
                            s.value for s in sides
                            if isinstance(s, ast.Constant)
                            and isinstance(s.value, str))
    return frozenset(sites)


def _hooked_sites() -> frozenset[str]:
    """Site names with a LIVE hook in the package tree (cached: the scan
    reads every module and the tree does not change under a validate
    call)."""
    global _HOOKED_SITES
    if _HOOKED_SITES is None:
        _HOOKED_SITES = fault_sites_in_tree()
    return _HOOKED_SITES


_HOOKED_SITES: frozenset[str] | None = None


def _check_fault_plan(errors, where: str, c: dict) -> None:
    """A manifest carrying $TPUJOB_FAULT_PLAN must carry a VALID plan —
    a typo'd plan silently not firing would pass a chaos run vacuously.
    ``@/path`` values are structural (the file lives in the container's
    filesystem, not here), so only inline JSON is parsed.

    Beyond the plan's own registry check, every site must also have a
    live hook in the code tree (:func:`fault_sites_in_tree`): a site can be
    valid per ``faults/plan.py`` SITES yet orphaned — its ``fire()`` call
    renamed or deleted — in which case the fault would validate fine and
    then silently never fire."""
    for e in c.get("env", []):
        if e.get("name") != "TPUJOB_FAULT_PLAN" or "value" not in e:
            continue
        raw = (e.get("value") or "").strip()
        if not raw or raw.startswith("@"):
            continue
        try:
            plan = FaultPlan.from_json(raw)
            plan.validate_or_raise()
        except (ValueError, TypeError) as ex:
            _err(errors, where, f"TPUJOB_FAULT_PLAN is not a valid fault "
                 f"plan: {ex}")
            continue
        hooked = _hooked_sites()
        for f in plan.faults:
            if f.site not in hooked:
                _err(errors, where,
                     f"TPUJOB_FAULT_PLAN names site {f.site!r} which has "
                     f"no live hook in the code tree (hooked: "
                     f"{sorted(hooked)}) — the fault would never fire")


def _check_tenants(errors, where: str, c: dict) -> None:
    """A manifest carrying $TPUJOB_TENANTS must carry a VALID tenant
    config — same contract as the fault-plan check: a typo'd config
    (unknown key, duplicate id, nonpositive weight/rate) failing only at
    serving-worker startup wastes a scheduled GPU node. ``@/path``
    values are structural (the file lives in the container's filesystem,
    not here), so only inline JSON is parsed. Lazy import keeps validate
    usable without the serve package's dependencies loaded up front."""
    for e in c.get("env", []):
        if e.get("name") != "TPUJOB_TENANTS" or "value" not in e:
            continue
        raw = (e.get("value") or "").strip()
        if not raw or raw.startswith("@"):
            continue
        from k8s_distributed_deeplearning_torch.serve.sched.tenant import (
            parse_tenants)
        try:
            parse_tenants(raw)
        except (ValueError, TypeError) as ex:
            _err(errors, where,
                 f"TPUJOB_TENANTS is not a valid tenant config: {ex}")


def _check_fleet_endpoints(errors, where: str, c: dict) -> None:
    """A manifest carrying $TPUJOB_FLEET_ENDPOINTS must carry a
    parseable comma-separated target list — same render-time contract as
    the fault-plan/tenant checks: a typo'd endpoint list means the fleet
    scraper silently federates nothing. Each entry must be ``host:port``
    (or an http(s) URL) with a numeric port."""
    for e in c.get("env", []):
        if e.get("name") != "TPUJOB_FLEET_ENDPOINTS" or "value" not in e:
            continue
        raw = (e.get("value") or "").strip()
        if not raw:
            _err(errors, where, "TPUJOB_FLEET_ENDPOINTS is empty")
            continue
        for entry in raw.split(","):
            entry = entry.strip()
            if not entry:
                _err(errors, where, "TPUJOB_FLEET_ENDPOINTS has an empty "
                     "entry (trailing/doubled comma?)")
                continue
            hostport = entry
            if "://" in entry:
                if not entry.startswith(("http://", "https://")):
                    _err(errors, where, f"TPUJOB_FLEET_ENDPOINTS entry "
                         f"{entry!r} has a non-http(s) scheme")
                    continue
                hostport = entry.partition("://")[2].partition("/")[0]
            host, sep, port = hostport.rpartition(":")
            if not sep or not host or not port.isdigit() or not (
                    0 < int(port) < 65536):
                _err(errors, where, f"TPUJOB_FLEET_ENDPOINTS entry "
                     f"{entry!r} is not host:port with a valid port")


_DRAFT_PRESETS = frozenset({"micro", "tiny"})


def _check_spec(errors, where: str, c: dict) -> None:
    """A manifest carrying speculative-decoding env must carry a COHERENT
    pair — same offline contract as the fault-plan/tenant checks: a
    serving worker that dies at startup on a bad --spec-k wastes a
    scheduled GPU node. $TPUJOB_DRAFT_MODEL must name a known draft
    preset (serve/cli.py choices) and $TPUJOB_SPEC_K must be an integer
    >= 1; each requires the other."""
    env = {e.get("name"): e for e in c.get("env", [])}
    draft = env.get("TPUJOB_DRAFT_MODEL")
    spec_k = env.get("TPUJOB_SPEC_K")
    if draft is None and spec_k is None:
        return
    if (draft is None) != (spec_k is None):
        _err(errors, where, "TPUJOB_DRAFT_MODEL and TPUJOB_SPEC_K must be "
             "set together (speculative decoding needs both a draft "
             "preset and a draft count)")
    if draft is not None:
        val = (draft.get("value") or "").strip()
        if val not in _DRAFT_PRESETS:
            _err(errors, where, f"TPUJOB_DRAFT_MODEL {val!r} is not a "
                 f"known draft preset ({sorted(_DRAFT_PRESETS)})")
    if spec_k is not None:
        raw = (spec_k.get("value") or "").strip()
        if not raw.isdigit() or int(raw) < 1:
            _err(errors, where, f"TPUJOB_SPEC_K {raw!r} must be an "
                 "integer >= 1")


# Serving preset geometry, mirrored from the serve/cli.py --preset /
# --draft-model recipes as (n_heads, n_kv_heads, head_dim, n_layers,
# kv_itemsize): importing serve.cli here would drag torch into offline
# validation, so the numbers are literal (the tests hold this table to
# the real preset configs so it cannot drift silently).
_SERVE_PRESET_GEOM = {
    "tiny": (4, 2, 16, 2, 4),       # config_tiny defaults, float32 KV
    "small": (12, 4, 64, 12, 2),    # bfloat16 KV
}
_DRAFT_PRESET_GEOM = {
    "micro": (2, 1),
    "tiny": (4, 2),
}

_QTY_SUFFIX = (("Ki", 2 ** 10), ("Mi", 2 ** 20), ("Gi", 2 ** 30),
               ("Ti", 2 ** 40), ("K", 10 ** 3), ("M", 10 ** 6),
               ("G", 10 ** 9), ("T", 10 ** 12))


def _qty_bytes(qty) -> int | None:
    """Kubernetes resource quantity -> bytes (None when unparseable —
    the quantity-syntax check already flagged malformed values)."""
    s = str(qty)
    for suf, mult in _QTY_SUFFIX:
        if s.endswith(suf):
            try:
                return int(float(s[:-len(suf)]) * mult)
            except ValueError:
                return None
    try:
        return int(s)
    except ValueError:
        return None


def _int_flag(cmd: str, flag: str, default: int) -> int:
    m = re.search(rf"{re.escape(flag)}\s+(\d+)", cmd)
    return int(m.group(1)) if m else default


def _check_tp(errors, where: str, c: dict) -> None:
    """A manifest carrying $TPUJOB_SERVE_TP must be launchable offline:
    tp an integer >= 1; the pod's ``nvidia.com/gpu`` limit exactly tp;
    the preset's attention geometry divisible by tp for both the target
    and any draft preset; and the per-shard KV pool bytes within the
    container memory limit (the JAX package's checks)."""
    env = {e.get("name"): e for e in c.get("env", [])}
    tp_env = env.get("TPUJOB_SERVE_TP")
    if tp_env is None:
        return
    raw = (tp_env.get("value") or "").strip()
    if not raw.isdigit() or int(raw) < 1:
        _err(errors, where,
             f"TPUJOB_SERVE_TP {raw!r} must be an integer >= 1")
        return
    tp = int(raw)
    chips = (c.get("resources", {}).get("limits") or {}).get("nvidia.com/gpu")
    if chips is not None and str(chips).isdigit() and int(chips) != tp:
        _err(errors, where,
             f"TPUJOB_SERVE_TP ({tp}) != nvidia.com/gpu limit ({chips}) — "
             "the tp world runs one process a card; extra cards idle, "
             "fewer make ranks share a card through the host")
    cmd = " ".join(str(x) for x in
                   (c.get("command") or []) + (c.get("args") or []))
    m = re.search(r"--preset\s+(\S+)", cmd)
    preset = m.group(1) if m else "tiny"
    geom = _SERVE_PRESET_GEOM.get(preset)
    if geom is not None:
        heads, kv, head_dim, layers, itemsize = geom
        if heads % tp or kv % tp:
            _err(errors, where,
                 f"preset {preset!r} (n_heads={heads}, num_kv_heads={kv}) "
                 f"is not divisible by TPUJOB_SERVE_TP ({tp}) — every "
                 "shard must own whole attention/KV heads")
        elif env.get("TPUJOB_KV_QUANT") is None:
            # _check_quant owns the int8 byte math when kv_quant is set.
            slots = _int_flag(cmd, "--slots", 8)
            max_seq = _int_flag(cmd, "--max-seq-len", 512)
            pool = _int_flag(cmd, "--kv-pool-pages", 0)
            page_tokens = 32            # engine default: min_bucket
            blocks = -(-max_seq // page_tokens)
            pages = (pool if pool > 0 else slots * blocks) + 1
            per_shard = (pages * page_tokens * (kv // tp) * head_dim
                         * itemsize * 2 * layers)
            mem = _qty_bytes((c.get("resources", {}).get("limits") or {})
                             .get("memory", ""))
            if mem is not None and per_shard > mem:
                _err(errors, where,
                     f"per-shard KV pool (~{per_shard / 2 ** 20:.0f} MiB "
                     f"at tp={tp}, preset {preset!r}) exceeds the "
                     f"container memory limit ({mem / 2 ** 20:.0f} MiB) — "
                     "shrink the pool (--kv-pool-pages / --slots / "
                     "--max-seq-len) or raise the limit")
    draft = env.get("TPUJOB_DRAFT_MODEL")
    if draft is not None:
        dval = (draft.get("value") or "").strip()
        dgeom = _DRAFT_PRESET_GEOM.get(dval)
        if dgeom is not None and (dgeom[0] % tp or dgeom[1] % tp):
            _err(errors, where,
                 f"draft preset {dval!r} (n_heads={dgeom[0]}, "
                 f"num_kv_heads={dgeom[1]}) is not divisible by "
                 f"TPUJOB_SERVE_TP ({tp}) — the draft model shards over "
                 "the same tp mesh")


_QUANT_MODES = ("int8",)


def _check_quant(errors, where: str, c: dict) -> None:
    """A manifest carrying graftquant env must be launchable offline:
    mode names the engine knows (a typo'd mode dies in the ServeEngine
    ctor after a GPU node was scheduled); under $TPUJOB_KV_QUANT the
    pool-byte fit is checked with the QUANTIZED page cost (int8 lanes
    plus one f32 scale per KV head per token — the fp estimates in
    _check_pool_bytes/_check_tp over-state a quantized pool, so this is
    the bound that reflects what the pod actually allocates); and with
    tp the scale leaves' kv-head lane dim must split evenly over the
    mesh, the same divisibility the cache sharding asserts at boot."""
    env = {e.get("name"): e for e in c.get("env", [])}
    kvq = env.get("TPUJOB_KV_QUANT")
    wq = env.get("TPUJOB_WEIGHT_QUANT")
    if kvq is None and wq is None:
        return
    for label, e in (("TPUJOB_KV_QUANT", kvq),
                     ("TPUJOB_WEIGHT_QUANT", wq)):
        if e is None:
            continue
        raw = (e.get("value") or "").strip()
        if raw not in _QUANT_MODES:
            _err(errors, where,
                 f"{label} {raw!r} is not a known quant mode "
                 f"(have {list(_QUANT_MODES)}) — the ServeEngine ctor "
                 "rejects it at boot")
    if kvq is None or (kvq.get("value") or "").strip() != "int8":
        return
    tp_raw = ((env.get("TPUJOB_SERVE_TP") or {}).get("value") or "").strip()
    tp = int(tp_raw) if tp_raw.isdigit() and int(tp_raw) >= 1 else 1
    cmd = " ".join(str(x) for x in
                   (c.get("command") or []) + (c.get("args") or []))
    m = re.search(r"--preset\s+(\S+)", cmd)
    geom = _SERVE_PRESET_GEOM.get(m.group(1) if m else "tiny")
    if geom is None:
        return
    heads, kv, head_dim, layers, _itemsize = geom
    if kv % tp:
        _err(errors, where,
             f"TPUJOB_KV_QUANT with TPUJOB_SERVE_TP ({tp}): preset "
             f"num_kv_heads ({kv}) is not divisible by tp — the scale "
             "leaves shard their per-KV-head lane dim over the mesh")
        return
    slots = _int_flag(cmd, "--slots", 8)
    max_seq = _int_flag(cmd, "--max-seq-len", 512)
    pool = _int_flag(cmd, "--kv-pool-pages", 0)
    page_tokens = 32                # engine default: min_bucket
    blocks = -(-max_seq // page_tokens)
    pages = (pool if pool > 0 else slots * blocks) + 1
    # int8 lane byte + 4-byte f32 scale per kv head per token, per shard.
    per_shard = (pages * page_tokens * (kv // tp)
                 * (head_dim + 4) * 2 * layers)
    mem = _qty_bytes((c.get("resources", {}).get("limits") or {})
                     .get("memory", ""))
    if mem is not None and per_shard > mem:
        _err(errors, where,
             f"quantized per-shard KV pool (~{per_shard / 2 ** 20:.0f} "
             f"MiB at tp={tp}) exceeds the container memory limit "
             f"({mem / 2 ** 20:.0f} MiB) — int8 already shrank it; "
             "shrink the pool (--kv-pool-pages / --slots / "
             "--max-seq-len) or raise the limit")


def _check_flight(errors, where: str, c: dict) -> None:
    """A manifest carrying flight-recorder env must be COHERENT offline:
    $TPUJOB_FLIGHT_RING must be an integer >= 0 (0 renders but disables),
    and $TPUJOB_FLIGHT_DIR without a ring (or with ring 0) is a config
    that silently records nothing — the postmortem you reach for after
    the incident would not exist."""
    env = {e.get("name"): e for e in c.get("env", [])}
    ring = env.get("TPUJOB_FLIGHT_RING")
    fdir = env.get("TPUJOB_FLIGHT_DIR")
    if ring is None and fdir is None:
        return
    ring_val = None
    if ring is not None:
        raw = (ring.get("value") or "").strip()
        if not raw.isdigit():
            _err(errors, where, f"TPUJOB_FLIGHT_RING {raw!r} must be an "
                 "integer >= 0")
        else:
            ring_val = int(raw)
    if fdir is not None:
        if not (fdir.get("value") or "").strip():
            _err(errors, where, "TPUJOB_FLIGHT_DIR is empty")
        if ring is None or ring_val == 0:
            _err(errors, where, "TPUJOB_FLIGHT_DIR without an enabled "
                 "TPUJOB_FLIGHT_RING records nothing — set a ring size "
                 ">= 1 or drop the dir")


def _check_autoscale(errors, where: str, c: dict) -> None:
    """A manifest carrying elastic-serving env must be COHERENT offline —
    same contract as the spec/flight checks: a controller that dies at
    startup on min > max (or silently never brownouts because a stage
    name is typo'd) only shows up during the first overload, which is
    exactly when it must work. Min/max must be integers >= 1 with
    min <= max, cooldowns positive numbers, and every brownout stage a
    name serve/autoscale.py knows (lazy import, as with the tenant
    check)."""
    env = {e.get("name"): e for e in c.get("env", [])}
    a_min = env.get("TPUJOB_AUTOSCALE_MIN")
    a_max = env.get("TPUJOB_AUTOSCALE_MAX")
    keys = [k for k in env if k and k.startswith("TPUJOB_AUTOSCALE_")]
    if not keys:
        return
    min_val = max_val = None
    if a_min is not None:
        raw = (a_min.get("value") or "").strip()
        if not raw.isdigit() or int(raw) < 1:
            _err(errors, where, f"TPUJOB_AUTOSCALE_MIN {raw!r} must be "
                 "an integer >= 1")
        else:
            min_val = int(raw)
    if a_max is None:
        _err(errors, where, "autoscale env without TPUJOB_AUTOSCALE_MAX "
             "— the controller has no ceiling to scale toward")
    else:
        raw = (a_max.get("value") or "").strip()
        if not raw.isdigit() or int(raw) < 1:
            _err(errors, where, f"TPUJOB_AUTOSCALE_MAX {raw!r} must be "
                 "an integer >= 1")
        else:
            max_val = int(raw)
    if min_val is not None and max_val is not None and min_val > max_val:
        _err(errors, where, f"TPUJOB_AUTOSCALE_MIN ({min_val}) > "
             f"TPUJOB_AUTOSCALE_MAX ({max_val})")
    for key in ("TPUJOB_AUTOSCALE_UP_COOLDOWN_S",
                "TPUJOB_AUTOSCALE_DOWN_COOLDOWN_S"):
        e = env.get(key)
        if e is None:
            continue
        raw = (e.get("value") or "").strip()
        try:
            ok = float(raw) > 0
        except ValueError:
            ok = False
        if not ok:
            _err(errors, where, f"{key} {raw!r} must be a positive "
                 "number of seconds")
    brown = env.get("TPUJOB_AUTOSCALE_BROWNOUT")
    if brown is not None:
        raw = (brown.get("value") or "").strip()
        if not raw:
            _err(errors, where, "TPUJOB_AUTOSCALE_BROWNOUT is empty")
        else:
            from k8s_distributed_deeplearning_torch.serve.autoscale import (
                BROWNOUT_STAGE_NAMES)
            for stage in raw.split(","):
                if stage.strip() not in BROWNOUT_STAGE_NAMES:
                    _err(errors, where,
                         f"TPUJOB_AUTOSCALE_BROWNOUT stage "
                         f"{stage.strip()!r} is not a known brownout "
                         f"stage ({list(BROWNOUT_STAGE_NAMES)})")


_PRESTOP_SLEEP = re.compile(r"\bsleep\s+(\d+)\b")


def _check_termination(errors, where: str, tmpl: dict,
                       containers: list[dict]) -> None:
    """The graceful-shutdown contract: terminationGracePeriodSeconds must
    be a positive integer, and any preStop sleep must FIT inside it with
    room left for the actual drain. kubelet starts the grace clock when
    termination begins — the preStop hook runs inside it, so a sleep >=
    the grace period means SIGTERM arrives with zero (or negative) drain
    budget and the pod dies mid-request anyway; that mistake validates
    fine against the k8s schema and only shows up as lost requests during
    the first rolling update."""
    grace = tmpl.get("terminationGracePeriodSeconds")
    if grace is not None and (not isinstance(grace, int) or grace < 1):
        _err(errors, where, f"terminationGracePeriodSeconds {grace!r} must "
             "be a positive integer")
        grace = None
    effective_grace = grace if grace is not None else 30   # k8s default
    for c in containers:
        hook = ((c.get("lifecycle") or {}).get("preStop") or {})
        if not hook:
            continue
        cmd = (hook.get("exec") or {}).get("command")
        if not cmd:
            _err(errors, where, "preStop hook without an exec command "
                 "(only exec preStop hooks are rendered/supported)")
            continue
        m = _PRESTOP_SLEEP.search(" ".join(str(a) for a in cmd))
        if m and int(m.group(1)) >= effective_grace:
            _err(errors, where,
                 f"preStop sleep ({m.group(1)}s) >= termination grace "
                 f"period ({effective_grace}s"
                 f"{' default' if grace is None else ''}) — SIGTERM would "
                 "arrive with no drain budget left; raise "
                 "terminationGracePeriodSeconds or shrink the sleep")


_SERVING_ROLES = frozenset({"serve-gateway", "serve-replica",
                            "serve-prefill"})
# Roles that carry a ServeEngine (and therefore a KV pool) in the pod.
_ENGINE_ROLES = frozenset({"serve-replica", "serve-prefill"})


def _probe_port(probe: dict) -> object:
    return (probe.get("httpGet") or {}).get("port")


def _check_serving_probes(errors, where: str, c: dict) -> None:
    """Both serving roles must split readiness from liveness: readiness
    /readyz (503 while draining — the Service must stop routing before
    the drain handshake) and liveness /healthz (200 while draining — a
    kubelet restart mid-drain loses exactly the requests the drain
    protects). A manifest pointing both probes at /healthz validates fine
    against the k8s schema and only shows up as shed requests during the
    first rolling update."""
    env = {e.get("name"): (e.get("value") or "")
           for e in c.get("env", []) if "value" in e}
    port = env.get("TPUJOB_METRICS_PORT", "")
    for kind, path in (("readinessProbe", "/readyz"),
                       ("livenessProbe", "/healthz")):
        probe = c.get(kind)
        if not probe:
            _err(errors, where, f"serving container {c.get('name')!r} has "
                 f"no {kind} — the drain handshake depends on it")
            continue
        got = (probe.get("httpGet") or {}).get("path")
        if got != path:
            _err(errors, where, f"{kind} path {got!r} must be {path!r} "
                 "(readiness and liveness are different contracts while "
                 "draining)")
        if port and str(_probe_port(probe)) != port:
            _err(errors, where, f"{kind} port {_probe_port(probe)!r} != "
                 f"TPUJOB_METRICS_PORT ({port})")


def _container_argv(c: dict) -> list[str]:
    argv: list[str] = []
    for part in (c.get("command") or []) + (c.get("args") or []):
        argv.extend(str(part).split())
    return argv


def _gateway_endpoints(c: dict,
                       flag: str = "--replica-endpoints"
                       ) -> list[str] | None:
    """Pull an endpoint-list flag out of the gateway command (list argv
    or a ``sh -c`` string)."""
    argv = _container_argv(c)
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return [e for e in argv[i + 1].split(",") if e]
        if a.startswith(flag + "="):
            return [e for e in a.partition("=")[2].split(",") if e]
    return None


def _check_pool_bytes(errors, where: str, c: dict) -> None:
    """Per-role KV pool-byte check for every engine-carrying serving role
    (decode replicas AND prefill workers): the pool geometry the command
    flags imply must fit the container memory limit, or the pod OOMs at
    boot after a GPU node was scheduled for it. With $TPUJOB_SERVE_TP
    set, :func:`_check_tp` already covers the per-shard variant — this is
    the tp=1 path."""
    env = {e.get("name"): e for e in c.get("env", [])}
    if env.get("TPUJOB_SERVE_TP") is not None:
        return
    if env.get("TPUJOB_KV_QUANT") is not None:
        return                      # _check_quant owns the int8 byte math
    cmd = " ".join(str(x) for x in
                   (c.get("command") or []) + (c.get("args") or []))
    m = re.search(r"--preset\s+(\S+)", cmd)
    geom = _SERVE_PRESET_GEOM.get(m.group(1) if m else "tiny")
    if geom is None:
        return
    heads, kv, head_dim, layers, itemsize = geom
    slots = _int_flag(cmd, "--slots", 8)
    max_seq = _int_flag(cmd, "--max-seq-len", 512)
    pool = _int_flag(cmd, "--kv-pool-pages", 0)
    page_tokens = 32                # engine default: min_bucket
    blocks = -(-max_seq // page_tokens)
    pages = (pool if pool > 0 else slots * blocks) + 1
    total = pages * page_tokens * kv * head_dim * itemsize * 2 * layers
    mem = _qty_bytes((c.get("resources", {}).get("limits") or {})
                     .get("memory", ""))
    if mem is not None and total > mem:
        _err(errors, where,
             f"KV pool (~{total / 2 ** 20:.0f} MiB) exceeds the "
             f"container memory limit ({mem / 2 ** 20:.0f} MiB) — "
             "shrink the pool (--kv-pool-pages / --slots / "
             "--max-seq-len) or raise the limit")


def _check_serving_job(errors, where: str, job: dict,
                       by_kind: dict[str, list[dict]]) -> None:
    """The remote-serving contract: probes split readiness/liveness, the
    replica fleet has stable DNS through a headless Service, and the
    gateway's static endpoint list matches the replica Job it is rendered
    next to — a count or port drift here means a replica that is
    scheduled, billed, and never dispatched to."""
    role = (job["metadata"].get("labels") or {}).get("role")
    spec = job.get("spec", {})
    tmpl = spec.get("template", {}).get("spec", {})
    containers = tmpl.get("containers") or []
    for c in containers:
        _check_serving_probes(errors, where, c)
    subdomain = tmpl.get("subdomain")
    svc = next((s for s in by_kind.get("Service", [])
                if s["metadata"].get("name") == subdomain), None)
    if role in _ENGINE_ROLES:
        tier = "replica" if role == "serve-replica" else "prefill"
        for c in containers:
            _check_pool_bytes(errors, where, c)
        metrics_ports = [p.get("containerPort")
                         for c in containers for p in c.get("ports", [])]
        if svc is None:
            _err(errors, where, f"no headless Service named {subdomain!r} "
                 f"rendered — {tier} pod DNS (the gateway's endpoint "
                 "list) will not resolve")
        else:
            if svc["spec"].get("clusterIP") != "None":
                _err(errors, where, f"{tier} Service must be headless "
                     "(clusterIP: None) for per-pod DNS")
            for p in [p.get("port") for p in svc["spec"].get("ports", [])]:
                if p not in metrics_ports:
                    _err(errors, where, f"{tier} Service port {p} not "
                         f"exposed by the container ({metrics_ports})")
        return
    # Gateway: its endpoint lists must agree with the Jobs alongside.
    argv = _container_argv(containers[0]) if containers else []
    eps = _gateway_endpoints(containers[0]) if containers else None
    if eps is not None:
        _check_tier_endpoints(errors, where, eps, by_kind,
                              role="serve-replica", tier="replica")
    pre_eps = (_gateway_endpoints(containers[0], "--prefill-endpoints")
               if containers else None)
    prefill_jobs = [j for j in by_kind.get("Job", [])
                    if (j["metadata"].get("labels") or {}).get("role")
                    == "serve-prefill"]
    if pre_eps is None and prefill_jobs:
        _err(errors, where, "a serve-prefill Job is rendered but the "
             "gateway does not route to it (--disagg "
             "--prefill-endpoints) — the prefill tier would be "
             "scheduled, billed, and never dispatched to")
    if pre_eps is not None:
        if "--disagg" not in argv:
            _err(errors, where, "gateway has --prefill-endpoints "
                 "without --disagg — the plain failover gateway "
                 "ignores the prefill tier")
        if "--autoscale" in argv:
            _err(errors, where, "gateway combines --disagg with "
                 "--autoscale — the disagg coordinator replaces the "
                 "gateway the fleet controller actuates through "
                 "(serve/cli.py rejects the pair at startup)")
        _check_tier_endpoints(errors, where, pre_eps, by_kind,
                              role="serve-prefill", tier="prefill")


def _check_storm_job(errors, where: str, job: dict) -> None:
    """The chaos-soak Job (serve/storm.py): no gang, no Services, no
    probes — its contract is flag-domain sanity (a soak with steps=0 or
    p>1 dies at argparse INSIDE the pod, which is the expensive place to
    find out) plus one-attempt retry semantics (a same-seed retry would
    deterministically replay the same violation)."""
    spec = job.get("spec", {})
    tmpl = spec.get("template", {}).get("spec", {})
    containers = tmpl.get("containers") or []
    cmd = [str(x) for x in (containers[0].get("command") or [])] \
        if containers else []
    if "storm" not in cmd:
        _err(errors, where, "serve-storm Job must run `launch storm`")
        return

    def _flag(name):
        try:
            return cmd[cmd.index(name) + 1]
        except (ValueError, IndexError):
            return None

    steps = _flag("--steps")
    if steps is None or not steps.lstrip("-").isdigit() or int(steps) < 1:
        _err(errors, where, f"--steps must be an int >= 1, got {steps!r}")
    seed = _flag("--seed")
    if seed is not None and (not seed.lstrip("-").isdigit()
                             or int(seed) < 0):
        _err(errors, where, f"--seed must be an int >= 0, got {seed!r} "
             "(the seed is the replay key in every repro line)")
    reps = _flag("--replicas")
    if reps is not None and (not reps.lstrip("-").isdigit()
                             or int(reps) < 1):
        _err(errors, where, f"--replicas must be an int >= 1, got {reps!r}")
    if "--fault-rate" in cmd:
        i = cmd.index("--fault-rate")
        pair = cmd[i + 1:i + 3]
        try:
            lo, hi = (float(x) for x in pair)
            ok = 0.0 < lo <= hi <= 1.0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            _err(errors, where, f"--fault-rate needs 0 < LO <= HI <= 1, "
                 f"got {pair!r}")
    if spec.get("backoffLimit") != 0:
        _err(errors, where, "storm Job must have backoffLimit 0 — a "
             "same-seed retry deterministically replays the same failure")
    if tmpl.get("restartPolicy") != "Never":
        _err(errors, where, "storm pods need restartPolicy Never "
             "(one deterministic attempt)")


def _check_tier_endpoints(errors, where: str, eps: list[str],
                          by_kind: dict[str, list[dict]], *, role: str,
                          tier: str) -> None:
    """One endpoint per pod of the tier's Indexed Job, through its
    headless Service's stable pod DNS, on a port the container exposes —
    a count or port drift here means a pod that is scheduled, billed,
    and never dispatched to."""
    jobs = [j for j in by_kind.get("Job", [])
            if (j["metadata"].get("labels") or {}).get("role") == role]
    if not jobs:
        _err(errors, where, f"gateway has a static {tier} endpoint list "
             f"but no {role} Job is rendered alongside")
        return
    rj = jobs[0]
    completions = rj.get("spec", {}).get("completions")
    if len(eps) != completions:
        _err(errors, where, f"gateway lists {len(eps)} {tier} endpoints "
             f"but the {tier} Job has completions={completions}")
    r_tmpl = rj.get("spec", {}).get("template", {}).get("spec", {})
    r_sub = r_tmpl.get("subdomain")
    r_name = rj["metadata"].get("name")
    r_ns = rj["metadata"].get("namespace")
    r_ports = {str(p.get("containerPort"))
               for c in (r_tmpl.get("containers") or [])
               for p in c.get("ports", [])}
    for i, ep in enumerate(eps):
        host, sep, port = ep.rpartition(":")
        if not sep or not port.isdigit():
            _err(errors, where, f"{tier} endpoint {ep!r} is not "
                 "host:port with a numeric port")
            continue
        expect = f"{r_name}-{i}.{r_sub}.{r_ns}"
        if host != expect:
            _err(errors, where, f"{tier} endpoint host {host!r} != "
                 f"<{tier}-job>-{i}.<subdomain>.<ns> ({expect!r})")
        if port not in r_ports:
            _err(errors, where, f"{tier} endpoint port {port} not "
                 f"exposed by the {tier} container ({sorted(r_ports)})")


def validate(docs: list[dict]) -> list[str]:
    """Validate rendered manifests; returns a list of errors (empty = OK)."""
    errors: list[str] = []
    by_kind: dict[str, list[dict]] = {}
    for i, d in enumerate(docs):
        where = f"doc[{i}]"
        if not isinstance(d, dict) or not d.get("kind"):
            _err(errors, where, "not a Kubernetes object (no kind)")
            continue
        by_kind.setdefault(d["kind"], []).append(d)
        if not d.get("apiVersion"):
            _err(errors, where, "missing apiVersion")
        _check_name(errors, f"{where}({d['kind']})",
                    d.get("metadata", {}).get("name"))

    namespaces = {d["metadata"]["name"] for d in by_kind.get("Namespace", [])}
    for d in by_kind.get("Service", []) + by_kind.get("Job", []):
        ns = d["metadata"].get("namespace")
        if namespaces and ns not in namespaces:
            _err(errors, d["kind"], f"namespace {ns!r} is not rendered "
                 f"alongside (have {sorted(namespaces)})")

    for job in by_kind.get("Job", []):
        where = f"Job/{job['metadata'].get('name')}"
        spec = job.get("spec", {})
        comp, par = spec.get("completions"), spec.get("parallelism")
        if spec.get("completionMode") != "Indexed":
            _err(errors, where, "completionMode must be Indexed (gang rank "
                 "identity comes from the completion index)")
        if not (isinstance(comp, int) and comp >= 1 and comp == par):
            _err(errors, where, f"completions ({comp}) must equal "
                 f"parallelism ({par}) >= 1 for gang semantics")
        tmpl = spec.get("template", {}).get("spec", {})
        if tmpl.get("restartPolicy") not in ("Never", "OnFailure"):
            _err(errors, where, "Job pods need restartPolicy Never/OnFailure")
        containers = tmpl.get("containers") or []
        if not containers:
            _err(errors, where, "no containers in pod template")
        for c in containers:
            _check_container(errors, where, c)
        _check_termination(errors, where, tmpl, containers)

        role = (job["metadata"].get("labels") or {}).get("role")
        if role == "serve-storm":
            # The soak is a one-pod batch exercise: no gang, no probe
            # contract — just its own flag-domain + retry-policy checks.
            _check_storm_job(errors, where, job)
            continue
        if role in _SERVING_ROLES:
            # Serving roles have no process-group gang — their contract
            # is the probe split + gateway↔replica endpoint agreement.
            _check_serving_job(errors, where, job, by_kind)
            continue

        # The distributed-bootstrap contract (what a typo here costs: every
        # pod hangs in torch.distributed.init_process_group at startup).
        env = {e["name"]: e for e in containers[0].get("env", [])
               } if containers else {}
        name, ns = job["metadata"].get("name"), job["metadata"].get("namespace")
        coord = env.get("TPUJOB_COORDINATOR_ADDRESS", {}).get("value", "")
        host, _, port = coord.partition(":")
        subdomain = tmpl.get("subdomain")
        expect_host = f"{name}-0.{subdomain}.{ns}"
        if host != expect_host:
            _err(errors, where, f"coordinator host {host!r} != "
                 f"<job>-0.<subdomain>.<ns> ({expect_host!r})")
        if env.get("TPUJOB_NUM_PROCESSES", {}).get("value") != str(comp):
            _err(errors, where, "TPUJOB_NUM_PROCESSES != completions")
        pid_ref = (env.get("TPUJOB_PROCESS_ID", {}).get("valueFrom", {})
                   .get("fieldRef", {}).get("fieldPath", ""))
        if "job-completion-index" not in pid_ref:
            _err(errors, where, "TPUJOB_PROCESS_ID must come from the "
                 "job-completion-index annotation")
        for svc in by_kind.get("Service", []):
            if svc["metadata"].get("name") == subdomain:
                if svc["spec"].get("clusterIP") != "None":
                    _err(errors, where, "coordinator Service must be "
                         "headless (clusterIP: None) for per-pod DNS")
                ports = [p.get("port") for p in svc["spec"].get("ports", [])]
                if not port.isdigit():
                    _err(errors, where, f"coordinator port {port!r} is not "
                         "numeric")
                elif int(port) not in ports:
                    _err(errors, where, f"coordinator port {port} not "
                         f"exposed by Service ({ports})")
                break
        else:
            _err(errors, where, f"no headless Service named {subdomain!r} "
                 "rendered — pod DNS names will not resolve")
    return errors


def validate_or_raise(docs: list[dict]) -> None:
    errors = validate(docs)
    if errors:
        raise ValueError("manifest validation failed:\n  "
                         + "\n  ".join(errors))


def kubectl_available() -> bool:
    return shutil.which("kubectl") is not None


def kubectl_validate(yaml_text: str, server: bool = True,
                     timeout: int = 60) -> tuple[bool, str]:
    """``kubectl apply --dry-run`` the manifests (server-side when a cluster
    answers). Returns (ok, output); raises RuntimeError without kubectl."""
    if not kubectl_available():
        raise RuntimeError("kubectl not on PATH")
    mode = "server" if server else "client"
    proc = subprocess.run(
        ["kubectl", "apply", f"--dry-run={mode}", "-f", "-"],
        input=yaml_text, text=True, capture_output=True, timeout=timeout)
    return proc.returncode == 0, proc.stdout + proc.stderr
