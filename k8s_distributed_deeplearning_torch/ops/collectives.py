"""Collectives over dictionaries of tensors, on ``torch.distributed``.

Port of ``k8s_distributed_deeplearning_tpu/ops/collectives.py``: the
Horovod collective surface of the reference (average or Adasum allreduce
inside ``hvd.DistributedOptimizer``, a root broadcast at start). Where the
JAX package traces XLA collectives inside ``shard_map``, these call
``torch.distributed`` on a process group (NCCL on the card, gloo on the
CPU), one process per replica.

Adasum (Maleki et al., "Scaling Distributed Training with Adaptive
Summation") is the same recursive-doubling butterfly as the JAX package's:
log2(N) rounds of pairwise exchanges, each combining with

    Adasum(a, b) = (1 - a.b / (2 a.a)) a + (1 - a.b / (2 b.b)) b

and, for N not a power of two, a fold-in of the residual ranks before the
butterfly and a copy back after it.

``bucketed_pmean`` is the fused-buffer form of the mean (Horovod's tensor
fusion): one allreduce per bucket of flattened leaves.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

Tree = dict


def _world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def tree_psum(tree: Tree, group=None) -> Tree:
    """Sum every leaf across the group, in place; returns the tree."""
    for x in tree.values():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return tree


def tree_pmean(tree: Tree, group=None) -> Tree:
    """Mean of every leaf across the group, in place (a sum, then a divide
    by the world size, as JAX's pmean); returns the tree."""
    n = dist.get_world_size(group)
    for x in tree.values():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x.div_(n)
    return tree


def bucket_order(tree: Tree) -> list:
    """The leaves' order for bucketing: sorted keys, the order
    ``jax.tree.flatten`` gives the same dict, so a bucket plan made for
    the JAX package's leaves holds here."""
    return sorted(tree)


@torch.no_grad()
def bucketed_pmean(tree: Tree, group, bucket_ids) -> Tree:
    """Mean-allreduce *tree* as few fused flat buffers, in place; returns
    the tree. ``bucket_ids[i]`` is the bucket of the i-th leaf in
    :func:`bucket_order` (the plan of ``runtime.fusion.plan_buckets``).
    The leaves of a bucket are flattened in f32 and concatenated, reduced
    in one ``all_reduce``, divided by the world size, split, and cast
    back into their own tensors."""
    keys = bucket_order(tree)
    bucket_ids = list(bucket_ids)
    if len(bucket_ids) != len(keys):
        raise ValueError(f"{len(bucket_ids)} bucket ids for {len(keys)} "
                         "leaves")
    n = dist.get_world_size(group)
    for bucket in sorted(set(bucket_ids)):
        leaves = [tree[k] for k, b in zip(keys, bucket_ids) if b == bucket]
        flat = torch.cat([x.reshape(-1).float() for x in leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat /= n
        for x, part in zip(leaves, flat.split([x.numel() for x in leaves])):
            x.copy_(part.view(x.shape))
    return tree


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Dot product over all leaves (same keys), accumulated in f32."""
    return torch.stack([torch.vdot(a[k].float().reshape(-1),
                                   b[k].float().reshape(-1)) for k in a]).sum()


def _adasum_pair(a: Tree, b: Tree) -> Tree:
    ab, aa, bb = tree_dot(a, b), tree_dot(a, a), tree_dot(b, b)
    # Zero-norm guards: if a == 0 the result is b, and symmetrically.
    alpha = torch.where(
        aa > 0, 1.0 - ab / (2.0 * torch.where(aa > 0, aa, 1.0)), 0.0)
    beta = torch.where(
        bb > 0, 1.0 - ab / (2.0 * torch.where(bb > 0, bb, 1.0)), 0.0)
    return {k: (alpha * a[k].float() + beta * b[k].float()).to(a[k].dtype)
            for k in a}


def _exchange(tree: Tree, partner: int, group) -> Tree:
    """Send this rank's leaves to ``partner`` and receive its leaves."""
    got = {k: torch.empty_like(x) for k, x in tree.items()}
    ops = []
    for k in tree:
        ops.append(dist.P2POp(dist.isend, tree[k].contiguous(), partner,
                              group))
        ops.append(dist.P2POp(dist.irecv, got[k], partner, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def _send(tree: Tree, dst: int, group) -> None:
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, x.contiguous(), dst, group)
             for x in tree.values()]):
        req.wait()


def _recv(like: Tree, src: int, group) -> Tree:
    got = {k: torch.empty_like(x) for k, x in like.items()}
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.irecv, got[k], src, group) for k in got]):
        req.wait()
    return got


def adasum_reduce(grads: Tree, group=None) -> Tree:
    """Adasum-allreduce *grads* across the group, any world size N; every
    rank returns the same new tree.

    Power-of-two N: at round r each rank exchanges its running reduction
    with the rank differing in bit r and combines with the pair rule.
    Otherwise, with p the largest power of two <= N, residual rank p + j
    first folds its gradient into rank j, ranks 0..p-1 run the butterfly,
    and rank j returns the result to rank p + j."""
    rank, n = _world(group)
    p = 1 << (n.bit_length() - 1)
    r = n - p
    if rank >= p:                            # residual rank
        _send(grads, rank - p, group)
        return _recv(grads, rank - p, group)
    if rank < r:
        grads = _adasum_pair(grads, _recv(grads, rank + p, group))
    dist_ = 1
    while dist_ < p:
        grads = _adasum_pair(grads, _exchange(grads, rank ^ dist_, group))
        dist_ *= 2
    if rank < r:
        _send(grads, rank + p, group)
    return grads


def broadcast_from(tree: Tree, group=None, root: int = 0) -> Tree:
    """Every leaf takes rank ``root``'s value, in place (parity with
    ``hvd.BroadcastGlobalVariablesHook(0)``); returns the tree."""
    for x in tree.values():
        dist.broadcast(x, src=dist.get_global_rank(group, root)
                       if group is not None else root, group=group)
    return tree
