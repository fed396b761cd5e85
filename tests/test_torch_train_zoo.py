"""PyTorch port, ``examples/train_zoo_torch.py`` (the counterpart of
``examples/train_zoo.py``) on the CPU: every ``--model`` small preset
trains two steps through ``main(argv)``; a ResNet run killed at a step and
run again restores there, BatchNorm statistics included, and ends equal to
an unkilled run; two gloo ranks keep equal BatchNorm statistics (the step
averages them, as JAX's ``make_resnet_step`` pmeans them); the flags that
need sharded meshes raise naming ROADMAP.md, and the JAX script's errors
are the port's. The example lints clean under graftlint.
"""
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "train_zoo_torch.py"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location("train_zoo_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(model, ckdir, steps, *extra):
    return ["--model", model, "--device", "cpu", "--num-steps", str(steps),
            "--batch-size", "4", "--log-every", "1", "--prefetch", "0",
            "--checkpoint-dir", str(ckdir), *extra]


@pytest.mark.parametrize("model", ["resnet18", "vit", "bert", "moe"])
def test_each_small_preset_trains_two_steps(example, model, tmp_path,
                                            capsys):
    out = example.main(_argv(model, tmp_path, 2))
    assert out == {"num_steps": 2, "world_size": 1, "model": model}
    events = [line for line in capsys.readouterr().out.splitlines()
              if '"train_step"' in line]
    assert len(events) == 2
    assert (tmp_path / "2" / "state.pt").exists()


def _state(ckdir, step):
    return torch.load(Path(ckdir) / str(step) / "state.pt",
                      weights_only=True)


def test_resnet_resume_restores_bn_stats(example, tmp_path, capsys):
    """A run stopped at step 2 and run again to step 4 restores at 2 (its
    BatchNorm buffers too) and ends bitwise equal to an unkilled 4-step
    run: params, optimizer moments and running statistics."""
    example.main(_argv("resnet18", tmp_path / "whole", 4))
    example.main(_argv("resnet18", tmp_path / "split", 2))
    capsys.readouterr()
    example.main(_argv("resnet18", tmp_path / "split", 4))
    assert '"restore"' in capsys.readouterr().out
    whole, split = _state(tmp_path / "whole", 4), _state(tmp_path / "split", 4)
    stats = whole["batch_stats"]
    assert stats and any(not torch.equal(v, torch.zeros_like(v))
                         for k, v in stats.items() if k.endswith(".mean"))
    for part in ("params", "batch_stats"):
        for k, v in whole[part].items():
            assert torch.equal(v, split[part][k]), (part, k)
    for k, v in whole["opt_state"]["mu"].items():
        assert torch.equal(v, split["opt_state"]["mu"][k]), k


def test_two_gloo_ranks_keep_equal_bn_stats(tmp_path):
    """Two ranks, each on its own shard of the batch: after two steps the
    running statistics and the parameters are equal on both ranks, and the
    statistics have moved from their 0 / 1 start."""
    np.savez(tmp_path / "in.npz", steps=np.array(2),
             ckdir=np.array(str(tmp_path / "ck")))
    ctx = mp.spawn(torch_dp_worker.run_rank,
                   args=(2, t_dist.free_port(), str(tmp_path), "zoo"),
                   nprocs=2, join=False)
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("2 ranks did not finish in 180 s")
    outs = [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(2)]
    stats = [k for k in outs[0] if k.startswith("stats/")]
    assert len(stats) == 2 * 17     # bn_init and 4 blocks x 4: mean, var
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    moved = [k for k in stats if k.endswith(".mean")
             and np.abs(outs[0][k]).max() > 0]
    assert moved


def test_sharded_flags_raise_naming_the_roadmap(example, tmp_path):
    for flag in ("--tp", "--fsdp", "--expert"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            example.main(_argv("vit", tmp_path, 1, flag, "2"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        example.main(_argv("vit", tmp_path, 1, "--dp", "2"))


def test_eval_flags_raise_as_in_jax(example, tmp_path):
    for extra in (("--eval-every", "5"), ("--keep-best",)):
        with pytest.raises(ValueError, match="not wired into the zoo"):
            example.main(_argv("bert", tmp_path, 1, *extra))


def test_default_checkpoint_namespace_and_device(example, monkeypatch,
                                                 tmp_path):
    """Without --checkpoint-dir each member checkpoints under
    ``./checkpoints/zoo-<model>``; without --device cpu and without a GPU
    the example raises."""
    monkeypatch.chdir(tmp_path)
    example.main(["--model", "vit", "--device", "cpu", "--num-steps", "1",
                  "--batch-size", "4", "--prefetch", "0"])
    assert (tmp_path / "checkpoints" / "zoo-vit" / "1" / "state.pt").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main(["--model", "vit", "--num-steps", "1"])


def test_example_lints_clean():
    """graftlint scans ``examples/`` (its default paths): the example adds
    no finding, alone or in the scan set."""
    from k8s_distributed_deeplearning_tpu import analysis
    assert analysis.run([str(EXAMPLE)]).findings == ()
    assert not [f for f in analysis.run().findings
                if f.path.endswith("train_zoo_torch.py")]
