"""PyTorch port, training: the loss, its gradients, chunked CE, the
optimizers and schedules, the token batchers and the 1-replica train step,
each against the JAX package on the same numpy-seeded inputs and the same
weights (converted from the JAX params).

Config: ``config_tiny`` (dim 64, 2 layers, 4 q heads, 2 KV heads, vocab
256) in float32 with f32 params on both sides. Tolerances: losses 1e-5
and gradients 1e-5 absolute / 1e-4 relative (f32 on both sides, sums in
different orders; observed differences ~1e-7); optimizer states 1e-6 /
1e-5 (optax's f32 bias corrections against the port's float64 ones); the
batchers are held to exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.ops import chunked_ce as t_ce
from k8s_distributed_deeplearning_torch.ops import flash_attn as t_fa
from k8s_distributed_deeplearning_torch.parallel import (
    data_parallel as t_dp)
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist
from k8s_distributed_deeplearning_torch.train import data as t_data
from k8s_distributed_deeplearning_torch.train import loop as t_loop
from k8s_distributed_deeplearning_torch.train import optim as t_optim
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.ops import chunked_ce as j_ce
from k8s_distributed_deeplearning_tpu.parallel import data_parallel as j_dp
from k8s_distributed_deeplearning_tpu.parallel import mesh as j_mesh
from k8s_distributed_deeplearning_tpu.train import data as j_data
from k8s_distributed_deeplearning_tpu.train import optim as j_optim

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)

torch.set_num_threads(2)


def _jax_model(**kw):
    return j_llama.LlamaLM(j_llama.config_tiny(dtype=jnp.float32, **kw))


@pytest.fixture(scope="module")
def jparams():
    return _jax_model().init(jax.random.key(0),
                             jnp.zeros((1, 8), jnp.int32))["params"]


def _port_model(params, **kw):
    cfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32,
                              **kw)
    model = t_llama.LlamaLM(cfg, device="cpu")
    model.load_state_dict(t_convert.from_flax_params(cfg, params))
    return model


def _batch(seed, packed=False, b=2, s=41):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32)}
    if packed:
        batch["segment_ids"] = np.repeat(
            np.array([[1, 2, 3], [1, 1, 0]]), [12, 15, 14], axis=1).astype(
                np.int32)
        batch["mask"] = (batch["segment_ids"] != 0).astype(np.float32)
    return batch


LOSS_CASES = {
    "unchunked": dict(chunked=False),
    "chunked": dict(chunked=True, chunk_size=16),
    "packed": dict(chunked=False, packed=True),
    "chunked_packed_remat": dict(chunked=True, chunk_size=16, packed=True,
                                 remat=True),
}


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_and_every_gradient_match_jax(jparams, case):
    kw = dict(LOSS_CASES[case])
    packed, remat = kw.pop("packed", False), kw.pop("remat", False)
    batch = _batch(1, packed=packed)
    jmodel = _jax_model(remat=remat)
    (want, jaux), jgrads = jax.value_and_grad(
        lambda p: j_llama.loss_fn(jmodel, p, {k: jnp.asarray(v)
                                              for k, v in batch.items()},
                                  **kw), has_aux=True)(jparams)
    tmodel = _port_model(jparams, remat=remat)
    loss, aux = t_llama.loss_fn(
        tmodel, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)
    for k in ("accuracy", "perplexity"):
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   **LOSS_TOL)
    want_grads = t_convert.from_flax_params(tmodel.cfg, jgrads)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("policy,fwd_runs_per_layer",
                         [("dots", 2), ("dots_attn", 1), ("nothing", 2)])
def test_remat_policies_keep_gradients_and_rerun_flash_as_stated(
        jparams, monkeypatch, policy, fwd_runs_per_layer):
    """Each remat policy gives the loss and every gradient of the same
    model without remat (the same operations, run again), and runs the
    flash forward once per layer, plus once more per layer in the backward
    unless the policy saves its output ("dots_attn")."""
    runs = []
    flash_fwd = t_fa.flash_fwd

    def counted(*args):
        runs.append(1)
        return flash_fwd(*args)

    monkeypatch.setattr(t_fa, "flash_fwd", counted)
    batch = {k: torch.from_numpy(v) for k, v in _batch(1, packed=True).items()}
    got = {}
    for remat in (False, True):
        model = _port_model(jparams, attention_impl="flash", remat=remat,
                            remat_policy=policy)
        runs.clear()
        loss, _ = t_llama.loss_fn(model, batch, chunked=True, chunk_size=16)
        loss.backward()
        got[remat] = (loss.detach(), dict(model.named_parameters()),
                      len(runs))
    n_layers = model.cfg.n_layers
    assert got[False][2] == n_layers
    assert got[True][2] == fwd_runs_per_layer * n_layers
    torch.testing.assert_close(got[True][0], got[False][0], atol=1e-6,
                               rtol=1e-6)
    for name, p in got[True][1].items():
        torch.testing.assert_close(p.grad, got[False][1][name].grad,
                                   atol=1e-6, rtol=1e-6, msg=name)


@pytest.mark.parametrize("layout", ["dv", "vd"])
def test_chunked_ce_matches_jax(layout):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 20, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50) if layout == "dv" else (50, 16)).astype(
        np.float32)
    tgt = rng.integers(0, 50, (2, 20)).astype(np.int32)
    mask = (rng.random((2, 20)) > 0.2).astype(np.float32)

    def jf(x, w):
        return j_ce.chunked_softmax_cross_entropy(
            x, w, jnp.asarray(tgt), jnp.asarray(mask), chunk_size=8,
            w_layout=layout)

    (jl, jacc), (jgx, jgw) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    tl, tacc = t_ce.chunked_softmax_cross_entropy(
        tx, tw, torch.from_numpy(tgt), torch.from_numpy(mask), chunk_size=8,
        w_layout=layout)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(tacc), float(jacc), **LOSS_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), **GRAD_TOL)


@pytest.mark.parametrize("name", t_optim.SCHEDULES)
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(name, warmup):
    want = j_optim.make_schedule(name, 0.01, 12, warmup)
    got = t_optim.make_schedule(name, 0.01, 12, warmup)
    for count in range(15):
        w = want(count) if callable(want) else want
        g = got(count) if callable(got) else got
        np.testing.assert_allclose(g, float(w), rtol=1e-6, atol=1e-9)


# (optimizer, schedule, warmup, moment_dtype, grad_clip)
OPT_CASES = [
    ("adam", "constant", 0, None, 1.0),
    ("adamw", "cosine", 2, None, 1.0),
    ("adamw", "linear", 0, None, 0.05),
    ("adamw", "constant", 2, "bfloat16", 1.0),
    ("sgd", "linear", 2, None, 1.0),
    ("sgd", "constant", 0, "bfloat16", None),
]


@pytest.mark.parametrize("case", OPT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_optimizer_steps_match_optax(case):
    """Three steps from the same params and gradients: params and moments
    agree with optax (clip active in every case but the unclipped one)."""
    name, sched, warmup, mdt, clip = case
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((8, 4)).astype(np.float32),
              "b": rng.standard_normal(16).astype(np.float32)}
    grads = [{k: 3 * rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = j_optim.make_optimizer(
        name, j_optim.make_schedule(sched, 0.01, 10, warmup), grad_clip=clip,
        moment_dtype=mdt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = t_optim.make_optimizer(
        name, t_optim.make_schedule(sched, 0.01, 10, warmup),
        grad_clip=clip, moment_dtype=mdt)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           tstate)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-5, err_msg=k)
    moments = [s for s in jax.tree.leaves(
        jstate, is_leaf=lambda x: hasattr(x, "mu") or hasattr(x, "trace"))
        if hasattr(s, "mu") or hasattr(s, "trace")][0]
    jm = moments.mu if hasattr(moments, "mu") else moments.trace
    tm = tstate["mu"] if "mu" in tstate else tstate["trace"]
    for k in params:
        assert tm[k].dtype == (torch.bfloat16 if mdt else torch.float32)
        np.testing.assert_allclose(tm[k].float().numpy(),
                                   np.asarray(jm[k], np.float32),
                                   atol=1e-6, rtol=1e-5, err_msg=k)


def test_unported_optimizers_raise():
    for name in ("adafactor", "lion"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_optim.make_optimizer(name, 0.1)


def test_token_batchers_match_jax():
    """Same seed, same batches: the synthetic corpus, TokenBatcher on two
    processes over two epochs, and the packed batcher."""
    want = j_data.synthetic_tokens(6000, vocab_size=300, seed=3)
    got = t_data.synthetic_tokens(6000, vocab_size=300, seed=3)
    np.testing.assert_array_equal(got, want)
    for pid in range(2):
        jb = j_data.TokenBatcher(want, 4, 16, seed=1, process_index=pid,
                                 num_processes=2)
        tb = t_data.TokenBatcher(got, 4, 16, seed=1, process_index=pid,
                                 num_processes=2)
        assert tb.batches_per_epoch == jb.batches_per_epoch
        for step in (0, 1, jb.batches_per_epoch, jb.batches_per_epoch + 3):
            np.testing.assert_array_equal(tb.batch_at(step)["tokens"],
                                          jb.batch_at(step)["tokens"])
    jdocs = j_data.split_documents(want, seed=2, approx_doc_len=40)
    tdocs = t_data.split_documents(got, seed=2, approx_doc_len=40)
    jp = j_data.PackedTokenBatcher(jdocs, 3, 32, seed=5)
    tp = t_data.PackedTokenBatcher(tdocs, 3, 32, seed=5)
    for step in range(3):
        for k, v in jp.batch_at(step).items():
            np.testing.assert_array_equal(tp.batch_at(step)[k], v)


@pytest.fixture
def world_of_one():
    t_dist.initialize_single("cpu")
    yield
    t_dist.shutdown()


def test_train_step_matches_jax_one_replica(jparams, world_of_one):
    """Three AdamW steps (clip 1.0, chunked CE) through the port's
    make_train_step and fit on a gloo world of one, against JAX's
    make_train_step on a 1-device mesh: losses per step, then every
    parameter through the converter."""
    tokens = j_data.synthetic_tokens(4096, vocab_size=256, seed=0)
    batcher = j_data.TokenBatcher(tokens, 4, 32, seed=0)
    batches = [batcher.batch_at(i) for i in range(3)]
    jmodel = _jax_model()
    tx = j_optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    mesh = j_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate = j_dp.init_state(jparams, tx, mesh)
    jstep = j_dp.make_train_step(
        lambda p, b, r: j_llama.loss_fn(jmodel, p, b, r, chunked=True,
                                        chunk_size=16), tx, mesh)
    jlosses = []
    for i, b in enumerate(batches):
        jstate, loss, _ = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])},
                                jax.random.key(i))
        jlosses.append(float(loss))

    tmodel = _port_model(jparams)
    opt = t_optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    state = t_dp.init_state(dict(tmodel.named_parameters()), opt)
    losses = []

    def step_fn(state, batch, seed):
        state, loss, aux = t_dp.make_train_step(
            lambda b, g: t_llama.loss_fn(tmodel, b, g, chunked=True,
                                         chunk_size=16), opt)(
            state, batch, seed)
        losses.append(float(loss))
        return state, loss, aux

    state = t_loop.fit(step_fn, state, iter(batches), 3, rng=0, log_every=0)
    assert state.step == 3
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    want = t_convert.from_flax_params(tmodel.cfg, jstate.params)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=name)


def test_evaluate_averages_over_batches(jparams):
    """loop.evaluate averages eval_step's metrics over the batches it
    draws, as the JAX loop's evaluate does."""
    tmodel = _port_model(jparams)
    batches = [_batch(s) for s in range(3)]

    def eval_step(model, batch):
        with torch.no_grad():
            loss, aux = t_llama.loss_fn(
                model, {k: torch.from_numpy(v) for k, v in batch.items()})
        return {"loss": loss, "accuracy": aux["accuracy"]}

    got = t_loop.evaluate(eval_step, tmodel, iter(batches), 3)
    want = [eval_step(tmodel, b) for b in batches]
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(
            got[k], np.mean([float(w[k]) for w in want]), rtol=1e-6)
