"""PyTorch port, the reference's MNIST job: ``models/mnist.py`` (through
``convert.mnist_from_flax``), the MNIST data pieces of ``train/data.py``
and ``train/mnist.py``, each against the JAX package on the same
numpy-seeded inputs and the same weights.

Tolerances (f32 on both sides, sums in different orders): logits 1e-5,
loss and gradients 1e-5. After three Adam steps, parameters are held per
tensor: the L2 distance from JAX's over the L2 change the steps made,
1e-4 (read: 4e-5 at most, on ``dense1.weight``). Per element they cannot
agree to 1e-6: Adam's first update is ``g / (|g| + 1e-8)``, so an
element whose gradient is near 1e-8 turns the two sides' rounding of it
(~1e-10) into updates ~2e-5 apart (34 of 3.2 M ``dense1`` elements after
one step), and later steps can flip a ReLU whose input sits at 0. Dropout
cannot match JAX's masks (another PRNG), so every parity case runs with
it off; with it on, the contract is same-seed determinism. The data
pieces are held to exact equality. Then the CLI trains the scikit-learn
digits fixture (real scanned digits) to >= 0.9 held-out accuracy.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import mnist as t_mnist
from k8s_distributed_deeplearning_torch.parallel import (
    data_parallel as t_dp)
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist
from k8s_distributed_deeplearning_torch.train import data as t_data
from k8s_distributed_deeplearning_torch.train import loop as t_loop
from k8s_distributed_deeplearning_torch.train import mnist as t_job
from k8s_distributed_deeplearning_torch.train import optim as t_optim
from k8s_distributed_deeplearning_tpu.models import mnist as j_mnist
from k8s_distributed_deeplearning_tpu.parallel import data_parallel as j_dp
from k8s_distributed_deeplearning_tpu.parallel import mesh as j_mesh
from k8s_distributed_deeplearning_tpu.train import data as j_data
from k8s_distributed_deeplearning_tpu.train import optim as j_optim

TOL = dict(atol=1e-5, rtol=1e-5)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jparams():
    return j_mnist.MNISTConvNet().init(
        jax.random.key(0), jnp.zeros((1, 28, 28, 1)), train=False)["params"]


def _port(params, rate=0.0):
    model = t_mnist.MNISTConvNet(dropout_rate=rate, device="cpu")
    model.load_state_dict(t_convert.mnist_from_flax(params))
    return model


def _batch(seed, n=8):
    x, y = j_data.synthetic_mnist(n, seed=seed)
    return {"image": x, "label": y}


@pytest.mark.parametrize("layout", ["nhwc", "flat"])
def test_forward_matches_jax(jparams, layout):
    x = _batch(1)["image"]
    if layout == "flat":
        x = x.reshape(len(x), 784)
    want = np.asarray(j_mnist.MNISTConvNet().apply({"params": jparams}, x))
    got = _port(jparams)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_loss_gradients_and_eval_match_jax(jparams):
    """Softmax CE, accuracy and every gradient with dropout off (rate 0
    on both sides), then ``eval_fn``."""
    batch = _batch(2, n=16)
    jmodel = j_mnist.MNISTConvNet(dropout_rate=0.0)
    (want, jaux), jgrads = jax.value_and_grad(
        lambda p: j_mnist.loss_fn(jmodel, p, batch, jax.random.key(0)),
        has_aux=True)(jparams)
    model = _port(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = t_mnist.loss_fn(model, tb, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert float(aux["accuracy"]) == float(jaux["accuracy"])
    want_grads = t_convert.mnist_from_flax(jgrads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOL)
    jev = j_mnist.eval_fn(jmodel, jparams, batch)
    ev = t_mnist.eval_fn(model, tb)
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]), **TOL)
    assert float(ev["accuracy"]) == float(jev["accuracy"])
    assert t_mnist.flops_per_example() == j_mnist.flops_per_example()


@pytest.fixture
def world_of_one():
    t_dist.initialize_single("cpu")
    yield
    t_dist.shutdown()


def test_three_adam_steps_match_jax(jparams, world_of_one):
    """The reference's optimizer (bare Adam, lr 1e-3) through the port's
    make_train_step and fit on a gloo world of one, against JAX's
    make_train_step on a 1-device mesh: losses, then every parameter."""
    batches = [_batch(10 + i, n=16) for i in range(3)]
    jmodel = j_mnist.MNISTConvNet(dropout_rate=0.0)
    tx = j_optim.make_optimizer("adam", 1e-3, grad_clip=None)
    mesh = j_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate = j_dp.init_state(jparams, tx, mesh)
    jstep = j_dp.make_train_step(
        lambda p, b, r: j_mnist.loss_fn(jmodel, p, b, r), tx, mesh)
    jlosses = []
    for i, b in enumerate(batches):
        jstate, loss, _ = jstep(jstate, b, jax.random.key(i))
        jlosses.append(float(loss))

    model = _port(jparams)
    opt = t_optim.make_optimizer("adam", 1e-3, grad_clip=None)
    step = t_dp.make_train_step(
        lambda b, g: t_mnist.loss_fn(model, b, g), opt)
    losses = []

    def logged(state, batch, seed):
        state, loss, aux = step(state, batch, seed)
        losses.append(float(loss))
        return state, loss, aux

    state = t_loop.fit(logged, t_dp.init_state(dict(model.named_parameters()),
                                               opt), iter(batches), 3, rng=0)
    assert state.step == 3
    np.testing.assert_allclose(losses, jlosses, **TOL)
    want = t_convert.mnist_from_flax(jstate.params)
    init = t_convert.mnist_from_flax(jparams)
    for name, p in model.named_parameters():
        diff = np.linalg.norm(p.detach().numpy() - want[name].numpy())
        change = np.linalg.norm(want[name].numpy() - init[name].numpy())
        assert diff <= 1e-4 * change, (name, diff / change)


def test_dropout_only_in_train_mode_and_same_seed_determinism():
    """Rate 0.5: eval mode is deterministic and mask-free; train mode
    draws its mask from the step's generator, the same for the same seed
    and another for another seed, and zeroes about half of the dense
    layer's activations."""
    model = t_mnist.MNISTConvNet(device="cpu", seed=3)
    x = torch.from_numpy(_batch(4)["image"])

    def gen(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    ev = model(x)
    assert torch.equal(ev, model(x))
    assert torch.equal(ev, model(x, generator=gen(0)))     # not train
    a = model(x, train=True, generator=gen(0))
    assert torch.equal(a, model(x, train=True, generator=gen(0)))
    assert not torch.equal(a, model(x, train=True, generator=gen(1)))
    assert not torch.equal(a, ev)
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    h = torch.ones(64, 1024)
    kept = (model._dropout(h, gen(0)) != 0).float().mean()
    assert 0.45 < float(kept) < 0.55
    assert torch.equal(model._dropout(h, gen(0)).unique(),
                       torch.tensor([0.0, 2.0]))
    off = t_mnist.MNISTConvNet(dropout_rate=0.0, device="cpu", seed=3)
    assert torch.equal(off(x, train=True), ev)


def test_synthetic_sets_match_jax():
    for kw in ({"num": 64, "seed": 0}, {"num": 33, "seed": 5,
                                        "sample_seed": 10_005}):
        for a, b in zip(t_data.synthetic_mnist(**kw),
                        j_data.synthetic_mnist(**kw)):
            np.testing.assert_array_equal(a, b)
    for split in ("train", "test"):
        for a, b in zip(t_data.load_or_synthesize(None, split, 400, seed=2),
                        j_data.load_or_synthesize(None, split, 400, seed=2)):
            np.testing.assert_array_equal(a, b)


def test_load_or_synthesize_refuses_a_missing_dir(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError, match="refusing to fall back"):
        t_data.load_or_synthesize(missing)
    with pytest.raises(FileNotFoundError, match="refusing to fall back"):
        j_data.load_or_synthesize(missing)


@pytest.fixture(scope="module")
def digits(tmp_path_factory):
    return t_data.make_digits_fixture(str(tmp_path_factory.mktemp("digits")))


def test_idx_round_trip_and_digits_fixture_match_jax(digits, tmp_path):
    """The port's fixture equals JAX's byte for byte once decoded; its idx
    files read back through both parsers alike; a written split reads
    back exactly."""
    jdir = j_data.make_digits_fixture(str(tmp_path / "j"))
    for split in ("train", "test"):
        mine = t_data.load_mnist(digits, split)
        for a, b, c in zip(mine, j_data.load_mnist(digits, split),
                           j_data.load_mnist(jdir, split)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert len(mine[0]) == 400 and mine[0].shape[1:] == (28, 28, 1)
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    ys = rng.integers(0, 10, 5).astype(np.uint8)
    out = tmp_path / "rt"
    out.mkdir()
    t_data.write_idx_dataset(str(out), xs, ys, "train")
    np.testing.assert_array_equal(
        t_data._read_idx(str(out / "train-images-idx3-ubyte")), xs)
    np.testing.assert_array_equal(
        j_data._read_idx(str(out / "train-labels-idx1-ubyte")), ys)
    with pytest.raises(ValueError, match="uint8"):
        t_data.write_idx_dataset(str(out), xs.astype(np.int32), ys, "t10k")


def test_mnist_available_and_resolve(digits, monkeypatch):
    """The fixture's archives are not MNIST's (their digests differ):
    neither copy accepts them with verification, both without."""
    monkeypatch.delenv("MNIST_DATA_DIR", raising=False)
    for lib in (t_data, j_data):
        assert not lib.mnist_available(digits)
        assert lib.mnist_available(digits, verify=False)
    assert t_data.resolve_mnist_dir(digits) is None
    sums = {n: t_data._md5(os.path.join(digits, n))
            for n in t_data.MNIST_FILES}
    assert t_data.mnist_available(digits, checksums=sums)
    assert t_data._md5(os.path.join(digits, "t10k-labels-idx1-ubyte.gz")) \
        == j_data._md5(os.path.join(digits, "t10k-labels-idx1-ubyte.gz"))


def test_sharded_batcher_matches_jax():
    x, y = j_data.synthetic_mnist(100, seed=1)
    for pi in range(3):
        mine = t_data.ShardedBatcher(x, y, 7, seed=4, process_index=pi,
                                     num_processes=3)
        ref = j_data.ShardedBatcher(x, y, 7, seed=4, process_index=pi,
                                    num_processes=3)
        assert mine.batches_per_epoch == ref.batches_per_epoch
        for step in (0, 1, 4, 9):
            a, b = mine.batch_at(step), ref.batch_at(step)
            for k in ("image", "label"):
                np.testing.assert_array_equal(a[k], b[k])


def test_cli_trains_the_digits_fixture(digits, tmp_path):
    """The job on real scanned digits (batch 32, 200 steps, the
    reference's Adam and dropout) reaches >= 0.9 on the 400 held-out
    digits, and writes its final checkpoint."""
    result = t_job.main(["--device", "cpu", "--data-dir", digits,
                         "--num-steps", "200", "--batch-size", "32",
                         "--log-every", "0", "--checkpoint-dir",
                         str(tmp_path / "ck"), "--prefetch", "0"])
    assert result["eval_examples"] == 400 and not result["preempted"]
    assert result["accuracy"] >= 0.9, result
    assert (tmp_path / "ck" / "200" / "state.pt").exists()


def test_cli_refuses_without_a_gpu_and_checks_its_flags():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_job.main(["--num-steps", "1"])
    with pytest.raises(ValueError, match="--eval-every"):
        t_job.main(["--device", "cpu", "--keep-best"])
