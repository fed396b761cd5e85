"""PyTorch port, fused gradient buckets (Horovod's tensor fusion):
``runtime/fusion.py`` over ``csrc/fusion.cc``, ``collectives.bucketed_pmean``
and ``reduce_gradients(bucket_bytes=...)``, held to the JAX package's
planner and reductions.

The bucket plans must equal JAX's exactly (same sizes, same threshold,
same ids); the cost model and the autotuner too, with alpha and beta given
to both sides. On 2 gloo ranks (``torch_dp_worker.py``, no JAX in the
ranks) the fused mean is bitwise the leaf-by-leaf one (a sum of two f32
values does not depend on the buffer it rides in) with one allreduce a
bucket, and a bucketed train step is bitwise the unbucketed one.
"""
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.ops import _build
from k8s_distributed_deeplearning_torch.ops import collectives as t_coll
from k8s_distributed_deeplearning_torch.parallel import (
    data_parallel as t_dp)
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist
from k8s_distributed_deeplearning_torch.runtime import fusion as t_fusion
from k8s_distributed_deeplearning_tpu.parallel import data_parallel as j_dp
from k8s_distributed_deeplearning_tpu.runtime import fusion as j_fusion

torch.set_num_threads(2)


def test_native_library_builds_into_the_ignored_build_dir():
    assert t_fusion.native_available()
    lib = _build.library_path("fusion")
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert lib.name.startswith("libfusion-")


def test_a_failed_build_raises_and_is_not_replaced(tmp_path, monkeypatch):
    """A fusion.cc that does not compile is an error: no quiet switch to
    the Python planner."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fusion.cc").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    assert not t_fusion.native_available()
    with pytest.raises(RuntimeError, match="fusion.cc"):
        t_fusion.plan_buckets([10, 20], 16)


def _random_sizes(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 1 << 22, size=int(rng.integers(1, 300)))
    sizes[rng.integers(0, len(sizes))] = 1 << 26          # oversized
    return sizes.tolist()


@pytest.mark.parametrize("threshold", [1, 4096, 1 << 22, 64 << 20])
@pytest.mark.parametrize("seed", range(3))
def test_plans_equal_the_plain_version_and_jax(seed, threshold):
    sizes = _random_sizes(seed)
    got = t_fusion.FusionPlanner(world=4, alpha_s=1e-6,
                                 beta_s_per_byte=1e-11).plan(sizes,
                                                             threshold)
    np.testing.assert_array_equal(
        got, t_fusion._plan_buckets_py(np.asarray(sizes), threshold))
    np.testing.assert_array_equal(
        got, j_fusion.FusionPlanner(world=4).plan(sizes, threshold))


def test_plan_examples_and_oversized_tensor():
    assert t_fusion.plan_buckets([10, 10, 10, 25, 5, 30], 30).tolist() == [
        0, 0, 0, 1, 1, 2]
    assert t_fusion.plan_buckets([100, 5, 5], 10).tolist() == [0, 1, 1]
    assert t_fusion.plan_buckets([], 10).tolist() == []


@pytest.mark.parametrize("world,alpha,beta", [(2, 5e-6, 1 / 20e9),
                                              (8, 2e-5, 1 / 300e9),
                                              (1, 1e-6, 1e-9)])
def test_cost_model_and_autotune_equal_jax(world, alpha, beta):
    sizes = _random_sizes(world)
    mine = t_fusion.FusionPlanner(world=world, alpha_s=alpha,
                                  beta_s_per_byte=beta)
    ref = j_fusion.FusionPlanner(world=world, alpha_s=alpha,
                                 beta_s_per_byte=beta)
    for t in (1 << 12, 1 << 20, 64 << 20):
        assert mine.modeled_comm_seconds(sizes, t) == \
            ref.modeled_comm_seconds(sizes, t)
    assert mine.autotune(sizes) == ref.autotune(sizes)
    assert mine.autotune(sizes, 1 << 12, 1 << 24) == \
        ref.autotune(sizes, 1 << 12, 1 << 24)


def test_autotune_prefers_fusion_for_small_tensors():
    p = t_fusion.FusionPlanner(world=16, alpha_s=5e-6,
                               beta_s_per_byte=1 / 100e9)
    sizes = [4096] * 500
    t = p.autotune(sizes, min_threshold=1 << 12, max_threshold=64 << 20)
    assert t >= (1 << 20)
    assert p.modeled_comm_seconds(sizes, t) < \
        p.modeled_comm_seconds(sizes, 1 << 12)


def test_autotune_rejects_nonpositive_min_threshold():
    with pytest.raises(ValueError):
        t_fusion.FusionPlanner(world=2, alpha_s=1e-6,
                               beta_s_per_byte=1e-10).autotune(
                                   [10, 20], min_threshold=0)


def test_planner_has_no_default_link():
    """Alpha and beta belong to the link: the planner takes no default."""
    with pytest.raises(TypeError):
        t_fusion.FusionPlanner(world=2)


def test_probe_memcpy_bandwidth_positive():
    assert t_fusion.probe_memcpy_bandwidth(nbytes=1 << 20, iters=4) > 1e8


def test_bucket_order_is_jax_flatten_order():
    import jax

    tree = {"z": 1, "a.b": 2, "a": 3, "m.0.w": 4}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert t_coll.bucket_order(tree) == [path[0].key for path, _ in flat]


def test_bucket_bytes_with_adasum_raises_jax_error():
    with pytest.raises(ValueError) as want:
        j_dp.reduce_gradients({}, "data", 2, j_dp.Reduction.ADASUM,
                              bucket_bytes=1024)
    with pytest.raises(ValueError) as got:
        t_dp.reduce_gradients({}, None, t_dp.Reduction.ADASUM,
                              bucket_bytes=1024)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Reduction.SUM"):
        t_dp.reduce_gradients({}, None, t_dp.Reduction.SUM,
                              bucket_bytes="auto")


def _spawn(tmp_path, world, mode, inputs, timeout_s=180):
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


SHAPES = {"c": (8, 4), "a": (3, 2), "b": (300,), "d": (7,)}


def test_bucketed_pmean_is_tree_pmean_bitwise_on_two_ranks(tmp_path):
    """Buckets over the sorted leaves a, b | c | d: the same bits as the
    leaf-by-leaf mean on both ranks, with one allreduce a bucket."""
    rng = np.random.default_rng(0)
    inputs = {f"g{r}/{k}": rng.standard_normal(s).astype(np.float32)
              for r in range(2) for k, s in SHAPES.items()}
    ids = np.asarray([0, 0, 1, 2])
    outs = _spawn(tmp_path, 2, "bucketed", {**inputs, "ids": ids})
    for out in outs:
        assert int(out["n_fused"]) == 3
        for k in SHAPES:
            np.testing.assert_array_equal(out[f"fused/{k}"],
                                          out[f"plain/{k}"], err_msg=k)
            np.testing.assert_array_equal(
                out[f"fused/{k}"],
                (inputs[f"g0/{k}"] + inputs[f"g1/{k}"]) / 2, err_msg=k)


def test_bucketed_train_step_is_the_unbucketed_one_on_two_ranks(tmp_path):
    """Two AdamW steps of the tiny Llama on 2 ranks, gradients reduced in
    64 KiB buckets, give the unbucketed run's losses and parameters bit
    for bit."""
    cfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32)
    model = t_llama.LlamaLM(cfg, device="cpu")
    rng = np.random.default_rng(1)
    inputs = {f"p/{k}": v.detach().numpy()
              for k, v in model.state_dict().items()}
    inputs["batches"] = rng.integers(0, 256, (2, 4, 17)).astype(np.int32)
    plain = _spawn(tmp_path, 2, "step", inputs)
    fused = _spawn(tmp_path, 2, "step", {**inputs, "bucket_bytes":
                                         np.asarray(64 << 10)})
    sizes = [p.numel() * 4 for _, p in sorted(model.named_parameters())]
    assert t_fusion.plan_buckets(sizes, 64 << 10).max() >= 2
    for a, b in zip(plain, fused):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_auto_threshold_probes_the_group_and_ranks_agree(tmp_path):
    """``bucket_bytes="auto"``: a world of one has no hops, so the model
    prices every plan at 0 and the smallest threshold wins; on 2 ranks
    the measured link is the same on both, and so is the plan."""
    t_dist.initialize_single("cpu")
    try:
        grads = {k: torch.zeros(s) for k, s in SHAPES.items()}
        assert t_dp.plan_buckets(grads, None, "auto") == [0, 0, 0, 0]
        assert t_fusion.probe_allreduce() == (0.0, 0.0)
    finally:
        t_dist.shutdown()
    rng = np.random.default_rng(2)
    inputs = {f"g{r}/{k}": rng.standard_normal(s).astype(np.float32)
              for r in range(2) for k, s in SHAPES.items()}
    outs = _spawn(tmp_path, 2, "bucketed", {**inputs, "ids": np.zeros(4),
                                            "auto": np.asarray(1)})
    assert outs[0]["link"].tolist() == outs[1]["link"].tolist()
    assert outs[0]["link"][0] > 0
    assert outs[0]["auto_ids"].tolist() == outs[1]["auto_ids"].tolist()
