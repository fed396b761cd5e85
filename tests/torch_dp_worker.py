"""Rank worker for the port's multi-process tests
(tests/test_torch_data_parallel.py, test_torch_fusion.py,
test_torch_checkpoint.py, test_torch_train_zoo.py).

Imports torch and the port only, so the spawned rank processes never
import JAX. Each rank joins a gloo group on localhost, reads its inputs
from ``<dir>/in.npz`` and writes ``<dir>/out_<rank>.npz``.
"""
import numpy as np
import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.models import llama
from k8s_distributed_deeplearning_torch.ops import collectives
from k8s_distributed_deeplearning_torch.parallel import data_parallel as dp
from k8s_distributed_deeplearning_torch.runtime import fusion
from k8s_distributed_deeplearning_torch.train import optim
from k8s_distributed_deeplearning_torch.train.preemption import (
    PreemptionHandler)


def _tree(data, prefix):
    return {k[len(prefix):]: torch.from_numpy(v.copy())
            for k, v in data.items() if k.startswith(prefix)}


def _reduce(rank, data):
    """Every reduction of this rank's fixed gradients, and a broadcast of
    rank-specific params from rank 0."""
    out = {}
    for red in dp.Reduction:
        if red is dp.Reduction.ADASUM or dist.get_world_size() == 2:
            got = dp.reduce_gradients(_tree(data, f"g{rank}/"), reduction=red)
            out.update({f"{red.value}/{k}": v.numpy() for k, v in got.items()})
    params = dp.broadcast_params(_tree(data, f"g{rank}/"))
    out.update({f"bcast/{k}": v.numpy() for k, v in params.items()})
    return out


def _bucketed(rank, data):
    """This rank's gradients reduced as fused buckets (the plan in
    ``data["ids"]``) and leaf by leaf, counting the allreduces of each."""
    calls = []
    all_reduce = dist.all_reduce

    def counted(*a, **kw):
        calls.append(1)
        return all_reduce(*a, **kw)

    dist.all_reduce = counted
    try:
        fused = collectives.bucketed_pmean(_tree(data, f"g{rank}/"), None,
                                           data["ids"])
        n_fused = len(calls)
        plain = collectives.tree_pmean(_tree(data, f"g{rank}/"))
    finally:
        dist.all_reduce = all_reduce
    out = {f"fused/{k}": v.numpy() for k, v in fused.items()}
    out.update({f"plain/{k}": v.numpy() for k, v in plain.items()})
    out["n_fused"] = np.asarray(n_fused)
    if "auto" in data:
        out["link"] = np.asarray(fusion.probe_allreduce())
        out["auto_ids"] = np.asarray(
            dp.plan_buckets(_tree(data, f"g{rank}/"), None, "auto"))
    return out


def _agree(rank, data):
    """Only rank 1 is signalled; both ranks ask for the agreement."""
    h = PreemptionHandler()
    before = h.triggered
    if rank == 1:
        h.request()
    flags = [None, None]
    dist.all_gather_object(flags, before)
    agreed = h.agreed()
    got = [None, None]
    dist.all_gather_object(got, agreed)
    return {"before": np.asarray(flags), "agreed": np.asarray(got),
            "latched": np.asarray(h.triggered)}


def _step(rank, data):
    """Two AdamW steps of the tiny Llama on this rank's half of each
    global batch (with ``data["bucket_bytes"]``, as fused buckets)."""
    cfg = llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = llama.LlamaLM(cfg, device="cpu")
    model.load_state_dict(_tree(data, "p/"))
    opt = optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    state = dp.init_state(dict(model.named_parameters()), opt)
    bucket = int(data["bucket_bytes"]) if "bucket_bytes" in data else None
    step = dp.make_train_step(
        lambda b, g: llama.loss_fn(model, b, g, chunked=True, chunk_size=16),
        opt, bucket_bytes=bucket)
    world = dist.get_world_size()
    losses = []
    for i, tokens in enumerate(data["batches"]):
        per = tokens.shape[0] // world
        state, loss, _ = step(state,
                              {"tokens": tokens[rank * per:(rank + 1) * per]},
                              i)
        losses.append(float(loss))
    out = {f"p/{k}": v.detach().numpy() for k, v in state.params.items()}
    out["losses"] = np.asarray(losses)
    return out


def _zoo(rank, data):
    """``examples/train_zoo_torch.py --model resnet18`` on this rank for
    ``steps`` steps (each rank its own shard of the batch); the BN buffers
    and the parameters its state holds after them."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "train_zoo_torch.py")
    spec = importlib.util.spec_from_file_location("train_zoo_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    captured = {}
    fit = example.loop.fit

    def capture(*args, **kw):
        captured["state"] = fit(*args, **kw)
        return captured["state"]

    example.loop.fit = capture
    try:
        example.main(["--model", "resnet18", "--device", "cpu",
                      "--num-steps", str(int(data["steps"])),
                      "--batch-size", "4", "--log-every", "0",
                      "--prefetch", "0",
                      "--checkpoint-dir", str(data["ckdir"])])
    finally:
        example.loop.fit = fit
    state = captured["state"]
    return {**{f"stats/{k}": v.numpy() for k, v in state.batch_stats.items()},
            **{f"params/{k}": v.detach().numpy()
               for k, v in state.params.items()}}


def run_rank(rank: int, world: int, port: int, directory: str,
             mode: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        data = dict(np.load(f"{directory}/in.npz"))
        out = {"reduce": _reduce, "step": _step, "bucketed": _bucketed,
               "agree": _agree, "zoo": _zoo}[mode](rank, data)
        np.savez(f"{directory}/out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
