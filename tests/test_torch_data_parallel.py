"""PyTorch port, the data-parallel engine across processes: gloo ranks
spawned with ``torch.multiprocessing`` (the rank code is in
``torch_dp_worker.py``, which imports torch and the port only), held to
the JAX package's reductions and train step on a virtual CPU mesh of the
same size, on the same numpy-seeded inputs.

Tolerances: reductions 1e-6 (f32 sums of two or three terms; Adasum's dot
products sum their leaves in another order); the train step's losses
1e-5 and parameters 2e-5 absolute / 1e-4 relative after two AdamW steps
(f32 on both sides, observed differences ~1e-7).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

import torch_dp_worker
from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.parallel import data_parallel as j_dp
from k8s_distributed_deeplearning_tpu.parallel import mesh as j_mesh
from k8s_distributed_deeplearning_tpu.train import data as j_data
from k8s_distributed_deeplearning_tpu.train import optim as j_optim

SHAPES = {"w": (6, 4), "b": (5,)}


def _spawn(tmp_path, world, mode, inputs, timeout_s=180):
    """Run ``world`` gloo ranks to completion (a rank that raises fails
    the test; ranks still running after ``timeout_s`` are killed)."""
    np.savez(tmp_path / "in.npz", **inputs)
    ctx = mp.spawn(torch_dp_worker.run_rank,
                   args=(world, t_dist.free_port(), str(tmp_path), mode),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {timeout_s} s")
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(world)]


def _jax_reduce(grads, world, reduction):
    mesh = j_mesh.make_mesh({"data": world}, devices=jax.devices()[:world])
    stacked = {k: jnp.stack([g[k] for g in grads]) for k in SHAPES}
    fn = jax.shard_map(
        lambda t: j_dp.reduce_gradients(jax.tree.map(lambda x: x[0], t),
                                        "data", world, reduction),
        mesh=mesh, in_specs=P("data"), out_specs=P(), check_vma=False)
    return {k: np.asarray(v) for k, v in jax.jit(fn)(stacked).items()}


@pytest.mark.parametrize("world", [2, 3])
def test_reductions_and_broadcast_match_jax(tmp_path, world):
    """AVERAGE and SUM (world 2) and ADASUM (world 2, and 3 through the
    fold-in of the residual rank) on fixed per-rank gradients, every rank
    holding JAX's result; then a broadcast from rank 0."""
    rng = np.random.default_rng(world)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(world)]
    outs = _spawn(tmp_path, world, "reduce",
                  {f"g{r}/{k}": v for r, g in enumerate(grads)
                   for k, v in g.items()})
    reds = (["average", "sum", "adasum"] if world == 2 else ["adasum"])
    for red in reds:
        want = _jax_reduce(grads, world, j_dp.Reduction(red))
        for rank, out in enumerate(outs):
            for k in SHAPES:
                np.testing.assert_allclose(out[f"{red}/{k}"], want[k],
                                           atol=1e-6, rtol=1e-6,
                                           err_msg=f"{red} rank {rank} {k}")
    for out in outs:
        for k in SHAPES:
            np.testing.assert_array_equal(out[f"bcast/{k}"], grads[0][k])


def test_two_rank_train_step_matches_jax(tmp_path):
    """Two AdamW steps (clip 1.0, chunked CE) with each rank on half of
    the global batch, against JAX's make_train_step on a 2-device mesh on
    the whole batch: losses (averaged over replicas) and every parameter
    on every rank."""
    jmodel = j_llama.LlamaLM(j_llama.config_tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tokens = j_data.synthetic_tokens(4096, vocab_size=256, seed=1)
    batcher = j_data.TokenBatcher(tokens, 4, 32, seed=1)
    batches = np.stack([batcher.batch_at(i)["tokens"] for i in range(2)])

    tx = j_optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    mesh = j_mesh.make_mesh({"data": 2}, devices=jax.devices()[:2])
    jstate = j_dp.init_state(params, tx, mesh)
    jstep = j_dp.make_train_step(
        lambda p, b, r: j_llama.loss_fn(jmodel, p, b, r, chunked=True,
                                        chunk_size=16), tx, mesh)
    jlosses = []
    for i, b in enumerate(batches):
        jstate, loss, _ = jstep(jstate, {"tokens": jnp.asarray(b)},
                                jax.random.key(i))
        jlosses.append(float(loss))

    cfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32)
    sd = t_convert.from_flax_params(cfg, params)
    outs = _spawn(tmp_path, 2, "step",
                  {"batches": batches,
                   **{f"p/{k}": v.numpy() for k, v in sd.items()}})
    want = t_convert.from_flax_params(cfg, jstate.params)
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], jlosses, atol=1e-5,
                                   rtol=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(out[f"p/{k}"], v.numpy(), atol=2e-5,
                                       rtol=1e-4, err_msg=f"rank {rank} {k}")
