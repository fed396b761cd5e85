"""Tensor-parallel serving runtime: one process a shard, rank 0 driving.

The JAX engine runs its serving programs under ``shard_map`` over a 1-D
``("tp",)`` mesh, one program for every device. The port runs one
process a shard (Megatron's and vLLM's shape):

- Rank 0 holds the whole :class:`serve.engine.ServeEngine`: scheduler,
  prefix trie, page allocator, gateway hooks and samplers, and its own
  shard. Ranks 1..tp-1 run :func:`follow`: they hold only their shard of
  each engine's model(s) and paged pool(s), keyed by engine id, so one
  rank-0 process can drive several tp engines (a gateway's replicas).
- Every device program of an engine goes through one seam
  (:meth:`TpWorld.send` then :meth:`Shard.run`): rank 0 broadcasts a small
  header (program id, engine id, integer arguments, operand shapes and
  dtypes), then the operands (tokens, cursors, block tables, positions,
  the draft window, page indices), and every rank runs the same model
  call on its shard. The model's row-parallel all-reduces
  (``models/transformer.py``) meet inside it. Every host decision
  (sampled tokens, the draft's proposals, accept counts, page
  allocation) is made on rank 0 and reaches the followers as an operand:
  followers never sample.
- A follower's shard is built from rank 0's weights (on its card or on
  the host): rank 0 broadcasts each whole tensor, one at a time, every
  rank keeps its slice
  (``parallel/sharding.py``), and one all-reduced checksum holds each
  rank's slices to rank 0's. The paged pool is born sharded: each rank
  allocates only ``[pages, page_tokens, kv/tp·hd]`` (plus its ``[..,
  kv/tp]`` f32 scales under int8 KV).
- Exports gather full-width pages: every rank writes its lanes into a
  zero-filled full-width buffer and one all-reduce sums them, so a tp
  engine's blob is a tp=0 engine's. Imports broadcast full-width pages
  and each rank keeps its lanes.

The backend is chosen from the ranks' devices, explicitly, and printed:
gloo on the CPU; on the card NCCL when every rank has a card of its own,
gloo over CUDA tensors when ranks share one (NCCL refuses two ranks on a
device). The seam uses only ``broadcast`` and ``all_reduce``, the two
collectives gloo offers on CUDA tensors, and moves every operand as raw
bytes (``uint8``; gloo has no int16 sum, so bf16 cannot travel as its
int16 view). The activations' all-reduce is a real sum in the compute
dtype. Every wait carries the world's timeout, so a dead rank fails the
others instead of hanging them.
"""
from __future__ import annotations

import dataclasses
import importlib
import pickle
import sys
from datetime import timedelta

import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.models import generate
from k8s_distributed_deeplearning_torch.ops import paged_attn
from k8s_distributed_deeplearning_torch.parallel import mesh as mesh_lib
from k8s_distributed_deeplearning_torch.parallel import sharding
from k8s_distributed_deeplearning_torch.serve import quant

# The seam's programs.
DECODE, VERIFY, FORWARD, EXPORT, IMPORT, HASH, CHECK, STATS, CREATE, \
    CLOSE, SHUTDOWN = range(1, 12)
_HEADER = 64             # int64 words in the first broadcast of a header
_DTYPES = (torch.int32, torch.int64, torch.int8, torch.uint8, torch.float32,
           torch.bfloat16, torch.float16)

# Per-rank readings :meth:`TpWorld.stats` gathers: the paged-attention
# kernel's launch counters, then the device's peak allocated bytes.
STAT_KEYS = tuple(
    f"launches{route}{mode}"
    for mode in ("", "_int8")
    for route in ("", "_decode", "_prefill", "_tf32x3", "_small")
) + ("peak_bytes",)

_WORLD: "TpWorld | None" = None


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a ``uint8`` view (same storage), for transport."""
    t = t if t.dim() else t.reshape(1)
    return t if t.dtype == torch.uint8 else t.view(torch.uint8)


def backend_for(device_type: str, world: int) -> tuple[str, str]:
    """``(backend, why)`` for ``world`` ranks on ``device_type``: gloo on
    the CPU; NCCL when every rank has a card of its own; gloo over CUDA
    tensors when ranks share a card."""
    if device_type != "cuda":
        return "gloo", "CPU ranks"
    n = torch.cuda.device_count()
    if n >= world:
        return "nccl", f"{world} ranks on {world} cards"
    return "gloo", (f"{world} ranks share {n} card(s): NCCL refuses two "
                    "ranks on one device, gloo moves CUDA tensors through "
                    "the host")


class TpWorld:
    """This process's place in the tp world: rank, size, device, backend,
    and on rank 0 the follower processes it started."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str, procs=()):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.procs = list(procs)
        self.group = mesh_lib.axis_group(sharding.SERVE_TP_AXIS)
        self._next_engine = 0

    # ------------------------------------------------------------ the seam

    def _bcast(self, t: torch.Tensor) -> None:
        dist.broadcast(_wire(t), 0, group=self.group)

    def send(self, prog: int, engine: int, args=(), operands=()) -> None:
        """Rank 0: broadcast one program's header, then its operands. The
        header's first word is its length: one that does not fit in
        :data:`_HEADER` words (an import of many pool tensors) sends the
        rest in a second broadcast."""
        ops = [o.contiguous() for o in operands]
        words = [0, prog, engine, len(args), len(ops), *args]
        for o in ops:
            words += [_DTYPES.index(o.dtype), o.dim(), *o.shape]
        words[0] = len(words)
        words += [0] * (_HEADER - len(words))
        header = torch.tensor(words, dtype=torch.int64, device=self.device)
        self._bcast(header[:_HEADER])
        if len(words) > _HEADER:
            self._bcast(header[_HEADER:])
        for o in ops:
            self._bcast(o)

    def recv(self) -> tuple[int, int, tuple, list]:
        """A follower: the next program's id, engine id, arguments and
        operands (on this rank's device)."""
        header = torch.empty(_HEADER, dtype=torch.int64, device=self.device)
        self._bcast(header)
        words = header.tolist()
        if words[0] > _HEADER:
            rest = torch.empty(words[0] - _HEADER, dtype=torch.int64,
                               device=self.device)
            self._bcast(rest)
            words += rest.tolist()
        prog, engine, n_args, n_ops = words[1:5]
        args = tuple(words[5:5 + n_args])
        pos, ops = 5 + n_args, []
        for _ in range(n_ops):
            dtype, nd = _DTYPES[words[pos]], words[pos + 1]
            shape = words[pos + 2:pos + 2 + nd]
            pos += 2 + nd
            ops.append(torch.empty(shape, dtype=dtype, device=self.device))
        for o in ops:
            self._bcast(o)
        return prog, engine, args, ops

    # ------------------------------------------------------- world programs

    def stats(self, reset: bool = False) -> dict[str, list[float]]:
        """Rank 0: every rank's :data:`STAT_KEYS` readings, ``{key: [rank
        0's, rank 1's, ...]}``; ``reset`` then zeroes the launch counters
        and the peak-memory mark on every rank."""
        self.send(STATS, 0, (int(reset),))
        return self._stats(reset)

    def _stats(self, reset: bool) -> dict[str, list[float]]:
        fn = paged_attn.paged_decode_attention
        vals = [float(getattr(fn, k)) for k in STAT_KEYS[:-1]]
        vals.append(float(torch.cuda.max_memory_allocated(self.device))
                    if self.device.type == "cuda" else 0.0)
        table = torch.zeros((self.size, len(STAT_KEYS)), dtype=torch.float64,
                            device=self.device)
        table[self.rank] = torch.tensor(vals, dtype=torch.float64)
        dist.all_reduce(table, group=self.group)
        if reset:
            for k in STAT_KEYS[:-1]:
                setattr(fn, k, 0)
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        cols = table.cpu().tolist()
        return {k: [row[i] for row in cols] for i, k in enumerate(STAT_KEYS)}

    def ack(self) -> None:
        """Every rank, in step: one all-reduce, so rank 0 knows each
        follower got here (the end of its loop) before it leaves."""
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)

    def new_engine_id(self) -> int:
        self._next_engine += 1
        return self._next_engine


def current() -> TpWorld | None:
    """This process's tp world, or None."""
    return _WORLD


def init_world(rank: int, size: int, port: int, device_type: str, *,
               timeout_s: float = 600.0, procs=(), store=None) -> TpWorld:
    """Join the tp world as ``rank`` of ``size`` through the TCP store on
    localhost ``port`` (``store``: the store server itself, in the
    process that holds it): rank r takes ``cuda:(r % cards)`` (or the
    CPU), the backend :func:`backend_for` names (printed on stderr), and
    the 1-D ``"tp"`` mesh. Every collective waits at most
    ``timeout_s``."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError("this process is in a tp world already")
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend, why = backend_for(device_type, size)
    print(f"tp world: rank {rank} of {size} on {device}, backend {backend} "
          f"({why})", file=sys.stderr, flush=True)
    timeout = timedelta(seconds=timeout_s)
    if store is None:
        store = dist.TCPStore("localhost", port, size, is_master=False,
                              timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=size,
                            rank=rank, timeout=timeout)
    mesh_lib.make_mesh({sharding.SERVE_TP_AXIS: size},
                       device_type=device_type)
    _WORLD = TpWorld(rank, size, device, backend, procs)
    return _WORLD


def store_server(size: int, timeout_s: float = 600.0):
    """A TCP store server for a world of ``size`` on a localhost port the
    system picks as it binds (no other process can take it first): its
    ``port`` is what the ranks' :func:`init_world` connect to."""
    return dist.TCPStore("localhost", 0, size, is_master=True,
                         timeout=timedelta(seconds=timeout_s),
                         wait_for_workers=False)


def launch(tp: int, device: str | torch.device = "cuda", *,
           timeout_s: float = 600.0) -> TpWorld:
    """Rank 0: start ``tp - 1`` follower processes (``spawn``, daemonic:
    they die with this process) and join the world with them, rank 0
    holding the store. A world of one (``tp=1``) starts none."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1 for a tp world, got {tp}")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tp world on cuda: no CUDA device is visible "
                           "(pass device='cpu' to run on the CPU)")
    store = store_server(tp, timeout_s)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower_main, daemon=True,
                         args=(r, tp, store.port, device_type, timeout_s))
             for r in range(1, tp)]
    for p in procs:
        p.start()
    return init_world(0, tp, store.port, device_type, timeout_s=timeout_s,
                      procs=procs, store=store)


def leave() -> None:
    """Leave this process's tp world: its process group and mesh axes."""
    global _WORLD
    _WORLD = None
    dist.destroy_process_group()
    mesh_lib.forget_meshes()


def shutdown(timeout_s: float = 60.0) -> None:
    """Rank 0: tell every follower to exit and wait until each has left
    its loop (one all-reduce), leave the world, and wait for the
    processes it started (at most ``timeout_s``). Raises when a follower
    exited with an error or did not exit."""
    world = _WORLD
    if world is None:
        return
    try:
        if world.rank == 0:
            world.send(SHUTDOWN, 0)
            world.ack()
    finally:
        leave()
    bad = []
    for p in world.procs:
        p.join(timeout_s)
        if p.is_alive():
            p.kill()
            p.join()
            bad.append(f"{p.name} did not exit in {timeout_s} s")
        elif p.exitcode != 0:
            bad.append(f"{p.name} exited with {p.exitcode}")
    if bad:
        raise RuntimeError("tp followers failed: " + "; ".join(bad))


def _follower_main(rank: int, size: int, port: int, device_type: str,
                   timeout_s: float) -> None:
    world = init_world(rank, size, port, device_type, timeout_s=timeout_s)
    try:
        follow(world)
    finally:
        leave()


def follow(world: TpWorld) -> None:
    """A follower's loop: run rank 0's programs on this rank's shards
    until rank 0 sends SHUTDOWN."""
    shards: dict[int, Shard] = {}
    while True:
        prog, engine, args, ops = world.recv()
        if prog == SHUTDOWN:
            world.ack()
            return
        if prog == STATS:
            world._stats(bool(args[0]))
        elif prog == CREATE:
            spec = pickle.loads(ops[0].cpu().numpy().tobytes())
            shards[engine] = build_shard(world, spec)
        elif prog == CLOSE:
            shards.pop(engine, None)
        else:
            shards[engine].run(prog, args, ops)


# ------------------------------------------------------------- the shards


def paged_pool(cfg, num_pages: int, page_tokens: int, kv_quant: str | None,
               device) -> list[tuple]:
    """One layer's pool tensors for every layer of ``cfg`` (a whole model's
    or one rank's shard config): ``(pool_k, pool_v)`` ``[num_pages,
    page_tokens, kv·hd]`` at the compute dtype, or under int8 KV
    ``(pool_k, pool_v, k_scale, v_scale)``, the scales ``[.., kv]``
    f32."""
    kv = cfg.resolved_kv_heads
    shape = (num_pages, page_tokens, kv * cfg.resolved_head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kv_quant == "int8":
        return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
                 zeros(shape[:2] + (kv,), torch.float32),
                 zeros(shape[:2] + (kv,), torch.float32))
                for _ in range(cfg.n_layers)]
    return [(zeros(shape, cfg.dtype), zeros(shape, cfg.dtype))
            for _ in range(cfg.n_layers)]


def _checksum(tensors) -> torch.Tensor:
    """Order-free integer checksum of ``tensors``' bytes: ``[sum, sum of
    squares]`` int64 (wrapping, exact in any order), on the CPU."""
    acc = None
    for t in tensors:
        flat = _wire(t.contiguous()).reshape(-1)
        if acc is None:
            acc = torch.zeros(2, dtype=torch.int64, device=flat.device)
        for part in flat.split(1 << 22):       # 32 MiB of int64 at a time
            x = part.to(torch.int64)
            acc += torch.stack([x.sum(), (x * x).sum()])
    return (acc if acc is not None
            else torch.zeros(2, dtype=torch.int64)).cpu()


class Shard:
    """One engine's device state on one rank: its (shard of the) target
    model and, under speculative decoding, the draft's; one paged pool
    each; and the programs over them. ``world`` None: the whole models on
    one device (tp=0), run without any collective."""

    def __init__(self, models, caches, world: TpWorld | None = None):
        self.models = list(models)
        self.caches = list(caches)
        self.world = world
        self.last_logits: torch.Tensor | None = None

    def pool_tensors(self) -> list[torch.Tensor]:
        """The target pool's tensors in blob order."""
        return [t for layer in self.caches[0] for t in layer]

    def run(self, prog: int, args: tuple, ops):
        """Run one program on this rank's shard. Returns the logits (for
        DECODE, VERIFY and a FORWARD that asks for them), the full-width
        page tensors (EXPORT), the consistency verdict (HASH), or None."""
        if prog == DECODE:
            which = args[0]
            logits = generate.slot_decode_step(
                self.models[which], self.caches[which], *ops)
        elif prog == VERIFY:
            logits = generate.slot_verify_step(self.models[0],
                                               self.caches[0], *ops)
        elif prog == FORWARD:
            which, index = args
            chunk, positions, tables = ops
            logits = generate.prefill_chunk(
                self.models[which], self.caches[which], chunk,
                positions=positions, block_tables=tables,
                logits_index=None if index < 0 else index)
        elif prog == EXPORT:
            return self._export(ops[0])
        elif prog == IMPORT:
            return self._import(ops[0], ops[1:])
        elif prog == HASH:
            return self._hash()
        elif prog == CHECK:
            return self._check(*args, *ops)
        else:
            raise ValueError(f"unknown tp program {prog}")
        if self.world is not None and logits is not None:
            self.last_logits = logits
        return logits

    def _export(self, idx: torch.Tensor) -> list[torch.Tensor]:
        """Each pool tensor's pages ``idx``, full width: under tp every
        rank writes its lanes into a zero-filled full-width byte buffer and
        one all-reduce sums them (x + 0 is exact on bytes)."""
        out = []
        for t in self.pool_tensors():
            rows = t.index_select(0, idx)
            w = self.world
            if w is None:
                out.append(rows)
                continue
            full = torch.zeros(rows.shape[:-1] + (rows.shape[-1] * w.size,),
                               dtype=rows.dtype, device=rows.device)
            sharding.serve_tp_cache_shard(_wire(full), w.rank, w.size).copy_(
                _wire(rows))
            dist.all_reduce(_wire(full), group=w.group)
            out.append(full)
        return out

    def _import(self, idx: torch.Tensor, values) -> None:
        """Scatter full-width pages ``values`` (one a pool tensor) into
        pages ``idx``: each rank keeps its lanes."""
        w = self.world
        for t, v in zip(self.pool_tensors(), values):
            if w is not None:
                v = sharding.serve_tp_cache_shard(v, w.rank, w.size)
            t.index_copy_(0, idx, v)

    def _check(self, seed: int, atol_e9: int, rtol_e9: int,
               tables: torch.Tensor, positions: torch.Tensor
               ) -> list[list[float]]:
        """Hold this rank's paged-attention kernel to its plain version on
        this rank's own pool (the target's layer 0) at ``positions``
        ``[B, sq]`` through ``tables``, queries drawn from ``seed`` +
        rank: every rank's ``[max abs error, share of the limit atol +
        rtol x |plain|]`` (the limits in units of 1e-9), all-reduced.
        The kernel's launch counts as any other."""
        w = self.world
        cfg = self.models[0].cfg
        layer = self.caches[0][0]
        gen = torch.Generator(device=w.device).manual_seed(seed + w.rank)
        q = torch.randn((*positions.shape, cfg.n_heads,
                         cfg.resolved_head_dim), generator=gen,
                        device=w.device).to(cfg.dtype)
        kw = ({} if len(layer) == 2
              else {"k_scale": layer[2], "v_scale": layer[3]})
        out = paged_attn.paged_decode_attention(
            q, layer[0], layer[1], tables, positions, **kw).float()
        ref = paged_attn.paged_decode_attention_reference(
            q, layer[0], layer[1], tables, positions, **kw).float()
        err = (out - ref).abs()
        share = err / (atol_e9 * 1e-9 + rtol_e9 * 1e-9 * ref.abs())
        table = torch.zeros((w.size, 2), dtype=torch.float64,
                            device=w.device)
        table[w.rank, 0] = err.max().double()
        table[w.rank, 1] = share.max().double()
        dist.all_reduce(table, group=w.group)
        return table.cpu().tolist()

    def _hash(self) -> bool:
        """True when every rank's last logits are bit-equal (so their
        residual streams, and the K/V each writes from them, agree): an
        all-reduced max and min of each rank's checksum."""
        h = (_checksum([self.last_logits]) if self.last_logits is not None
             else torch.zeros(2, dtype=torch.int64)).to(self.world.device)
        lo = h.clone()
        dist.all_reduce(h, op=dist.ReduceOp.MAX, group=self.world.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.world.group)
        return bool(torch.equal(h, lo))


def local_spec(model, tp: int, **overrides):
    """``(module, class name, config)`` of the PER-SHARD model each rank
    runs for ``model`` under ``tp`` (JAX ``_local_tp_model``): n_heads,
    n_kv_heads and mlp_dim divided by tp, head_dim
    pinned to the whole model's (the default ``dim // n_heads`` would
    change as n_heads shrinks), the all-reduces on
    (``tp_axis="tp"``), and ``overrides`` (the engine's kv_quant)."""
    cfg = model.cfg
    local = dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.resolved_kv_heads // tp,
        head_dim=cfg.resolved_head_dim, mlp_dim=cfg.resolved_mlp_dim // tp,
        tp_axis=sharding.SERVE_TP_AXIS, **overrides)
    return type(model).__module__, type(model).__qualname__, local


def create_shard(world: TpWorld, models, *, num_pages: int,
                 page_tokens: int, kv_quant: str | None,
                 weight_quant: str | None = None) -> tuple[int, Shard]:
    """Rank 0: build one engine's shards on every rank. ``models`` is the
    target and optionally the draft (None: no draft; the target itself: a
    self-draft sharing its shard), on rank 0's device or on the host;
    under ``weight_quant="int8"`` each matmul weight is sharded at its
    int8 grid point, made one tensor at a time. Returns ``(engine id,
    rank 0's shard)``."""
    target, draft = models
    specs = [local_spec(target, world.size, kv_quant=kv_quant)]
    if draft is not None:
        specs.append("target" if draft is target
                     else local_spec(draft, world.size, kv_quant=kv_quant))
    spec = {"models": specs, "num_pages": num_pages,
            "page_tokens": page_tokens, "kv_quant": kv_quant}
    payload = torch.frombuffer(bytearray(pickle.dumps(spec)),
                               dtype=torch.uint8).to(world.device)
    engine = world.new_engine_id()
    world.send(CREATE, engine, (), (payload,))
    return engine, build_shard(world, spec, [
        _source(m, weight_quant) for m in models[:len(specs)]])


def _source(model, weight_quant: str | None):
    """``model``'s tensor of a state-dict name (its int8 grid point under
    ``weight_quant``), made when asked for."""
    state = model.state_dict()
    if weight_quant != "int8":
        return state.__getitem__
    deq = quant.dequantizer(model)

    def get(name):
        w = deq(name)
        return state[name] if w is None else w

    return get


def build_shard(world: TpWorld, spec: dict, sources=None) -> Shard:
    """Every rank, in step: build each local model of ``spec``, take this
    rank's slice of each whole tensor rank 0 broadcasts (``sources``: rank
    0's functions of a state-dict name, read one tensor at a time), check
    the slices against rank 0's by one all-reduced checksum, and allocate
    this rank's pools."""
    models = []
    sums = torch.zeros((2, world.size, 2), dtype=torch.int64)
    for i, entry in enumerate(spec["models"]):
        if entry == "target":
            models.append(models[0])
            continue
        module, qualname, cfg = entry
        cls = getattr(importlib.import_module(module), qualname)
        local = cls(cfg, device=world.device)
        for name, t in local.state_dict().items():
            full = torch.empty(sharding.serve_tp_full_shape(
                name, t.shape, world.size), dtype=t.dtype,
                device=world.device)
            if world.rank == 0:
                full.copy_(sources[i](name))
                for r in range(world.size):      # what rank r must hold
                    sums[0, r] += _checksum([sharding.serve_tp_shard(
                        name, full, r, world.size)])
            world._bcast(full)
            t.copy_(sharding.serve_tp_shard(name, full, world.rank,
                                            world.size))
        models.append(local)
    mine = [t for m in {id(m): m for m in models}.values()
            for t in m.state_dict().values()]
    sums[1, world.rank] = _checksum(mine)
    sums = sums.to(world.device)
    dist.all_reduce(sums, group=world.group)
    if not torch.equal(sums[0], sums[1]):
        bad = [r for r in range(world.size)
               if not torch.equal(sums[0, r], sums[1, r])]
        raise RuntimeError(f"tp shard construction: the weights of rank(s) "
                           f"{bad} differ from rank 0's slices")
    caches = [paged_pool(m.cfg, spec["num_pages"], spec["page_tokens"],
                         spec["kv_quant"], world.device) for m in models]
    if len(models) == 1:                  # no draft
        models.append(None)
        caches.append(None)
    return Shard(models, caches, world)
