"""PyTorch port, ResNet (``models/resnet.py``) against the JAX package's
on the same weights and running statistics (through
``models/convert.py`` ``resnet_from_flax``) and the same numpy-seeded
images: logits in eval mode (running statistics) and in training mode
(batch statistics), the new running statistics a training forward
returns, the smoothed loss and every gradient tensor, for each norm
(``batch``, ``ghost`` with statistics of fewer examples than the batch,
``group``) and both stems (``conv7``, ``s2d``); ResNet-50's parameter
count and FLOPs.

Config: ``resnet18_cifar`` (one bottleneck block a stage) at 32², batch 4,
with random ``bn3`` scales, 0.1 x N(0, 1) (JAX's zero init would make
every residual-branch gradient exactly 0) and running statistics from one
JAX training forward (not the 0/1 they start at). ``ghost`` takes its
statistics from 3 of the 4 examples at 64²: at 32² its last stage is 1x1,
a few values a channel, and f32 alone moves the logits by whole units.

The forward (logits, statistics, loss) is held in float32 on both sides:
logits 1e-4, statistics 1e-5, loss 1e-5. The gradients are held in
float64 on both sides (``jax.enable_x64``; the port's model
in f64, its statistics then in f64 as flax's are), each tensor's relative
L2 distance 1e-4: in f32 the JAX package's own BatchNorm backward is the
less accurate side (1.7e-4 from its f64 gradients for ``batch``, the
port's f32 9e-5, on this test's weights). ``GhostBatchNorm`` computes its
statistics in f32 in either dtype (its ``astype(jnp.float32)``, which the
port copies), as E[x^2] - E[x]^2: they cancel where a channel's mean is
large against its spread (max-pool outputs are >= 0; mean^2 / var up to
34 in stage 1), so at 2 of 4 examples the two packages' f32 reductions,
one formula summed in different orders, put the stem's gradients 4.9e-2
apart, the port's within 3e-6 of an f64 evaluation of the same network.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import resnet as t_resnet
from k8s_distributed_deeplearning_tpu.models import resnet as j_resnet

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4
BN3_SCALE = 0.1

# name: (norm, stats_examples, stem, image size)
VARIANTS = {"batch": ("batch", 32, "conv7", 32),
            "ghost_3_of_4": ("ghost", 3, "conv7", 64),
            "group": ("group", 32, "conv7", 32),
            "s2d_stem": ("batch", 32, "s2d", 32)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _randomize_bn3(params, rng):
    """Every block's ``bn3`` scale drawn from ``rng`` (JAX inits it at 0)."""
    out = {}
    for k, v in params.items():
        if k == "bn3":
            v = dict(v)
            v["scale"] = jnp.asarray(BN3_SCALE * rng.normal(
                size=v["scale"].shape).astype(np.float32))
        elif isinstance(v, dict):
            v = _randomize_bn3(v, rng)
        out[k] = v
    return out


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    norm, stats_examples, stem, size = VARIANTS[request.param]
    jm = j_resnet.ResNet((1, 1, 1, 1), 10, jnp.float32, norm,
                         stats_examples, stem)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4,)).astype(np.int32)
    variables = jax.jit(lambda x: jm.init(jax.random.key(1), x,
                                          train=False))(jnp.asarray(images))
    variables = dict(variables)
    variables["params"] = _randomize_bn3(variables["params"], rng)
    if "batch_stats" in variables:
        # Running statistics of one training forward on other images.
        other = (rng.normal(size=images.shape) * 2 + 0.5).astype(np.float32)
        _, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables,
                                                        jnp.asarray(other))
        variables["batch_stats"] = upd["batch_stats"]
    tm = t_resnet.ResNet((1, 1, 1, 1), 10, torch.float32, norm,
                         stats_examples, stem, device="cpu")
    sd = t_convert.resnet_from_flax(variables)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    return request.param, jm, variables, tm, images, labels


def test_logits_match_jax_in_eval_and_training_mode(pair):
    name, jm, variables, tm, images, _ = pair
    x = jnp.asarray(images)
    want_eval = _np(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, x))
    want_train, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, x)
    with torch.no_grad():
        got_eval = tm(_t(images)).numpy()
        got_train = tm(_t(images), train=True).numpy()
    np.testing.assert_allclose(got_eval, want_eval, **LOGIT_TOL)
    np.testing.assert_allclose(got_train, _np(want_train), **LOGIT_TOL)
    # GroupNorm has no running statistics: both modes are one function.
    assert (name == "group") == np.allclose(want_eval, _np(want_train),
                                            atol=1e-3)


def _jax_loss(jm, variables, images, labels, grad=True):
    """JAX ``resnet.loss_fn`` at ``variables``: ``((loss, aux), grads)``,
    or ``(loss, aux)`` without ``grad``."""
    jbatch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    stats = variables.get("batch_stats", {})

    def jloss(p):
        return j_resnet.loss_fn(jm, {"params": p, "batch_stats": stats},
                                jbatch)

    fn = jax.value_and_grad(jloss, has_aux=True) if grad else jloss
    return jax.jit(fn)(variables["params"])


def test_loss_and_new_running_stats_match_jax(pair):
    """``loss_fn``: the loss and accuracy, the new running statistics by
    buffer name (the BIASED batch variance, flax's momentum 0.9); the
    buffers themselves are not written."""
    name, jm, variables, tm, images, labels = pair
    loss, aux = _jax_loss(jm, variables, images, labels, grad=False)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.zero_grad()
    tloss, taux = t_resnet.loss_fn(tm, {"image": _t(images),
                                        "label": _t(labels)})
    tloss.backward()
    assert float(tloss.detach()) == pytest.approx(float(loss), abs=1e-5,
                                                  rel=1e-5)
    assert float(taux["accuracy"]) == pytest.approx(float(aux["accuracy"]))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    want_stats = {k: v for k, v in t_convert.resnet_from_flax(
        {"params": variables["params"],
         "batch_stats": aux["batch_stats"]}).items()
        if k.endswith((".mean", ".var"))}
    assert set(taux["batch_stats"]) == set(want_stats)
    assert (not want_stats) == (name == "group")
    for k, v in want_stats.items():
        np.testing.assert_allclose(taux["batch_stats"][k].numpy(),
                                   v.numpy(), **STATS_TOL, err_msg=k)


def test_gradients_match_jax_in_float64(pair):
    """Every parameter gradient of ``loss_fn``, both packages in f64 on the
    same (f32-valued) weights, statistics and images."""
    name, _, variables, _, images, labels = pair
    norm, stats_examples, stem, _ = VARIANTS[name]
    with jax.enable_x64(True):
        jm = j_resnet.ResNet((1, 1, 1, 1), 10, jnp.float64, norm,
                             stats_examples, stem)
        v64 = jax.tree.map(lambda a: jnp.asarray(_np(a), jnp.float64),
                           variables)
        _, grads = _jax_loss(jm, v64, images.astype(np.float64), labels)
        want = t_convert.resnet_from_flax(
            {"params": jax.tree.map(_np, grads)})
    tm = t_resnet.ResNet((1, 1, 1, 1), 10, torch.float64, norm,
                         stats_examples, stem, device="cpu").double()
    tm.load_state_dict(t_convert.resnet_from_flax(variables))
    loss, _ = t_resnet.loss_fn(tm, {"image": _t(images).double(),
                                    "label": _t(labels)})
    loss.backward()
    for n, p in tm.named_parameters():
        w = want[n].double()       # the converter writes f32 leaves
        rel = float((p.grad - w).norm() / w.norm().clamp_min(1e-300))
        assert rel <= GRAD_RTOL, (n, rel)


def test_running_variance_is_biased():
    """flax ``BatchNorm`` keeps the biased batch variance (``BatchNorm2d``
    the unbiased one): at momentum 0.9 from var 1, the new variance is
    0.9 + 0.1 x the population variance of each channel."""
    bn = t_resnet.BatchNorm(3, dtype=torch.float32)
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    out: dict = {}
    bn(x, True, out)
    pop = x.permute(1, 0, 2, 3).reshape(3, -1).var(1, unbiased=False)
    torch.testing.assert_close(out["var"], 0.9 + 0.1 * pop)
    torch.testing.assert_close(out["mean"], 0.1 * x.mean((0, 2, 3)))


def test_resnet50_parameter_count_and_flops_match_jax():
    """JAX ``tests/test_model_zoo.py:77``: ResNet-50 has JAX's parameter
    count (~25.6 M) and the same running-statistic leaves."""
    jm = j_resnet.resnet50()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    tm = t_resnet.resnet50(device="cpu")
    got = sum(p.numel() for p in tm.parameters())
    assert got == want and 25.0e6 < got < 26.0e6
    n_stats = len(jax.tree.leaves(shapes["batch_stats"]))
    assert len(list(tm.buffers())) == n_stats
    assert t_resnet.flops_per_example(160) == pytest.approx(
        j_resnet.flops_per_example(160), rel=1e-12)


def test_adafactor_on_the_resnet_leaves_matches_optax():
    """``convert.resnet_layout`` forms each conv kernel in flax's HWIO
    layout: three adafactor steps of random gradients on the flax
    ``resnet18_cifar``'s own leaves through optax (the JAX package's
    factory) and on the converted parameters through the port agree per
    tensor (distance over the change, 1e-4, as the Llama case in
    ``tests/test_torch_train.py``), and the factored row statistics sit
    under JAX's leaf paths with JAX's shapes."""
    import optax

    from k8s_distributed_deeplearning_torch.train import optim as t_optim
    from k8s_distributed_deeplearning_tpu.train import optim as j_optim

    jm = j_resnet.resnet18_cifar()
    jp = jax.jit(lambda x: jm.init(jax.random.key(1), x, train=False))(
        jnp.zeros((1, 32, 32, 3)))["params"]

    def port(tree):
        return {k: v.clone() for k, v in
                t_convert.resnet_from_flax({"params": tree}).items()}

    tp, start = port(jp), port(jp)
    tx = j_optim.make_optimizer("adafactor", 0.01, grad_clip=1.0)
    jstate = tx.init(jp)
    opt = t_optim.make_optimizer("adafactor", 0.01, grad_clip=1.0,
                                 layout=t_convert.resnet_layout())
    tstate = opt.init(tp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            np.shape(x)).astype(np.float32)), jp)
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = opt.apply(tp, port(jg), tstate)
    want = port(jp)
    for k, v in tp.items():
        change = float((want[k] - start[k]).double().norm())
        dist = float((v - want[k]).double().norm())
        assert dist <= 1e-4 * max(change, 1e-12), (k, dist, change)
    rows = {"/".join(q.key for q in path if hasattr(q, "key")): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jstate[1][0].v_row)[0]}
    assert sorted(rows) == sorted(tstate["v_row"])
    for leaf, row in rows.items():
        assert tuple(tstate["v_row"][leaf].shape) == row.shape, leaf
