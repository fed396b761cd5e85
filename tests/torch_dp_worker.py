"""Rank worker for tests/test_torch_data_parallel.py.

Imports torch and the port only, so the spawned rank processes never
import JAX. Each rank joins a gloo group on localhost, reads its inputs
from ``<dir>/in.npz`` and writes ``<dir>/out_<rank>.npz``.
"""
import numpy as np
import torch
import torch.distributed as dist

from k8s_distributed_deeplearning_torch.models import llama
from k8s_distributed_deeplearning_torch.parallel import data_parallel as dp
from k8s_distributed_deeplearning_torch.train import optim


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


def _step(rank, data):
    """Two AdamW steps of the tiny Llama on this rank's half of each
    global batch."""
    cfg = llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = llama.LlamaLM(cfg, device="cpu")
    model.load_state_dict(_tree(data, "p/"))
    opt = optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    state = dp.init_state(dict(model.named_parameters()), opt)
    step = dp.make_train_step(
        lambda b, g: llama.loss_fn(model, b, g, chunked=True, chunk_size=16),
        opt)
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


def run_rank(rank: int, world: int, port: int, directory: str,
             mode: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        data = dict(np.load(f"{directory}/in.npz"))
        out = _reduce(rank, data) if mode == "reduce" else _step(rank, data)
        np.savez(f"{directory}/out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
