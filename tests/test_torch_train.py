"""PyTorch port, training: the loss, its gradients, chunked CE, the
optimizers and schedules, the token batchers and the 1-replica train step,
each against the JAX package on the same numpy-seeded inputs and the same
weights (converted from the JAX params).

Config: ``config_tiny`` (dim 64, 2 layers, 4 q heads, 2 KV heads, vocab
256) in float32 with f32 params on both sides. Tolerances: losses 1e-5
and gradients 1e-5 absolute / 1e-4 relative (f32 on both sides, sums in
different orders; observed differences ~1e-7); optimizer states 1e-6 /
1e-5 (optax's f32 bias corrections against the port's float64 ones);
adafactor per tensor (L2 distance over the change <= 1e-4, as the adam
steps of the training checks) with its statistics to 1e-5, and lion per
element to 1e-6 apart from sign ties; the batchers, the token-shard files
and the refusals' messages are held to exact equality.
"""
import os

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


# Tensors for adafactor's two branches: factored (two dims >= 128, in
# 2-D and 3-D, square) and unfactored (a small matrix, a vector).
_AF_SHAPES = {"fac2": (256, 160), "fac3": (130, 3, 200), "square": (128, 128),
              "small": (100, 64), "vec": (64,)}


def _change_distance(got, want, start):
    """||got - want|| over ||want - start||: the per-tensor rule the adam
    steps are held to (an update's rounding is amplified where a moment
    is near its epsilon)."""
    return (np.linalg.norm(got - want)
            / max(np.linalg.norm(want - start), 1e-30))


def _lion_close(got, want, mu, g, b1=0.9):
    """Lion's update is a sign: per element within 1e-6, apart from sign
    ties where |b1 mu + (1 - b1) g| < 1e-7. With a bf16 moment, ``b1 *
    mu`` is rounded to bf16 by optax run eagerly (and by the port), but a
    jitted XLA step keeps the product in f32: an element whose sign the
    two evaluations disagree on is a tie too."""
    mu = torch.as_tensor(mu)
    b1_t = torch.tensor(b1, dtype=mu.dtype)
    g = (1 - b1) * torch.as_tensor(g)
    rounded = ((mu * b1_t).float() + g).numpy()
    kept = (mu.float() * b1_t.float() + g).numpy()
    tie = ((np.abs(rounded) < 1e-7) | (np.abs(kept) < 1e-7)
           | (np.sign(rounded) != np.sign(kept)))
    np.testing.assert_allclose(got[~tie], want[~tie], atol=1e-6, rtol=0)


# (optimizer, moment_dtype, schedule, warmup)
NEW_OPT_CASES = [("adafactor", None, "constant", 0),
                 ("adafactor", None, "cosine", 2),
                 ("lion", None, "constant", 0),
                 ("lion", "bfloat16", "linear", 2)]


@pytest.mark.parametrize("case", NEW_OPT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_adafactor_and_lion_steps_match_optax(case):
    """Four clipped steps from the same params and gradients against
    ``optax`` through JAX's ``make_optimizer``: adafactor per tensor on
    factored and unfactored tensors (its ``v_row``/``v_col``/``v`` state
    by optax's field names and shapes), lion per element with its
    moment in f32 or bf16."""
    name, mdt, sched, warmup = case
    rng = np.random.default_rng(6)
    params = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
              for k, s in _AF_SHAPES.items()}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(4)]
    tx = j_optim.make_optimizer(
        name, j_optim.make_schedule(sched, 0.01, 8, warmup), grad_clip=1.0,
        moment_dtype=mdt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    opt = t_optim.make_optimizer(
        name, t_optim.make_schedule(sched, 0.01, 8, warmup), grad_clip=1.0,
        moment_dtype=mdt)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = opt.init(tp)
    for g in grads:
        before = {k: np.asarray(jp[k]) for k in jp}
        jmu = None
        if name == "lion":
            jmu = {k: torch.from_numpy(np.array(v, np.float32)).to(
                torch.bfloat16 if mdt else torch.float32)
                for k, v in jstate[1][0].mu.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           tstate)
        if name == "lion":
            # Compare this step's update alone (from the same start).
            norm = np.sqrt(sum((v * v).sum() for v in g.values()))
            for k in params:
                gk = g[k] * min(1.0, 1.0 / norm)
                _lion_close(tp[k].numpy() - before[k],
                            np.asarray(jp[k]) - before[k], jmu[k], gk)
                tp[k].copy_(torch.from_numpy(np.array(jp[k])))
    inner = jstate[1]
    if name == "adafactor":
        fac = inner[0]
        for k in params:
            assert _change_distance(tp[k].numpy(), np.asarray(jp[k]),
                                    params[k]) <= 1e-4, k
            for field in ("v_row", "v_col", "v"):
                want = np.asarray(getattr(fac, field)[k])
                got = tstate[field][k]
                assert tuple(got.shape) == want.shape, (k, field)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-12, err_msg=(k, field))
        assert tstate["count"] == int(fac.count) == 4
    else:
        mu = inner[0].mu
        for k in params:
            assert tstate["mu"][k].dtype == (torch.bfloat16 if mdt
                                             else torch.float32)
            np.testing.assert_allclose(tstate["mu"][k].float().numpy(),
                                       np.asarray(mu[k], np.float32),
                                       atol=1e-6, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["scanned", "unrolled"])
def test_adafactor_runs_on_the_jax_models_leaves(scan_layers):
    """At head_dim 128 every kernel is factored: three steps of random
    gradients on a flax Llama's own leaves (layers stacked when scanned)
    through optax, and on the converted parameters through the port with
    ``flax_layout``: every parameter per tensor, and the factored
    statistics by JAX leaf path and shape."""
    jcfg = j_llama.config_tiny(dtype=jnp.float32, dim=256, n_heads=2,
                               n_kv_heads=1, mlp_dim=512,
                               scan_layers=scan_layers)
    jp = j_llama.LlamaLM(jcfg).init(jax.random.key(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    jp = jax.tree.map(lambda x: x, jp)
    tcfg = t_llama.config_tiny(dtype=torch.float32, dim=256, n_heads=2,
                               n_kv_heads=1, mlp_dim=512)
    tp = {k: v.clone() for k, v in
          t_convert.from_flax_params(tcfg, jp).items()}
    start = {k: v.clone() for k, v in tp.items()}
    tx = j_optim.make_optimizer("adafactor", 0.01, grad_clip=1.0)
    jstate = tx.init(jp)
    opt = t_optim.make_optimizer(
        "adafactor", 0.01, grad_clip=1.0,
        layout=t_convert.flax_layout(tcfg, scan_layers=scan_layers))
    tstate = opt.init(tp)
    rng = np.random.default_rng(3)
    for _ in range(3):
        jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            np.shape(x)).astype(np.float32)), jp)
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = opt.apply(tp, t_convert.from_flax_params(tcfg, jg), tstate)
    want = t_convert.from_flax_params(tcfg, jp)
    for k in tp:
        assert _change_distance(tp[k].numpy(), want[k].numpy(),
                                start[k].numpy()) <= 1e-4, k
    fac = jstate[1][0]
    leaves = {"/".join(q.key for q in path if hasattr(q, "key")): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  fac.v_row)[0]}
    assert sorted(leaves) == sorted(tstate["v_row"])
    factored = 0
    for leaf, row in leaves.items():
        got = tstate["v_row"][leaf]
        assert tuple(got.shape) == row.shape, leaf
        factored += row.shape != (1,)
        np.testing.assert_allclose(got.numpy(), np.asarray(row), rtol=1e-5,
                                   atol=1e-12, err_msg=leaf)
    # The norm scales alone are unfactored: stacked [2, 256] (or [256]
    # each) have no second dim of 128.
    assert factored == len(leaves) - (3 if scan_layers else 5)


@pytest.mark.parametrize("name,mdt", [("adafactor", None), ("lion", None),
                                      ("lion", "bfloat16")])
def test_new_optimizer_state_saves_and_restores_bitwise(name, mdt, tmp_path):
    """Two steps, a save through the port's ``Checkpointer``, a restore
    into a fresh state, two more steps: bit for bit the four steps of an
    unbroken run."""
    from k8s_distributed_deeplearning_torch.train.checkpoint import (
        Checkpointer)
    rng = np.random.default_rng(8)
    params = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
              for k, s in _AF_SHAPES.items()}
    grads = [{k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in params.items()} for _ in range(4)]
    opt = t_optim.make_optimizer(name, 0.01, grad_clip=1.0,
                                 moment_dtype=mdt)

    def fresh():
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        return t_dp.init_state(p, opt)

    def steps(state, gs):
        for g in gs:
            state = state._replace(
                opt_state=opt.apply(state.params, g, state.opt_state),
                step=state.step + 1)
        return state

    unbroken = steps(fresh(), grads)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(2, steps(fresh(), grads[:2]))
    ck.close()
    restored, step = Checkpointer(str(tmp_path / "ck")).restore_latest(
        fresh())
    assert step == 2
    resumed = steps(restored, grads[2:])
    for k in params:
        assert torch.equal(resumed.params[k], unbroken.params[k]), k
    flat = lambda st: {(f, k): v for f, d in st.items()
                       if isinstance(d, dict) for k, v in d.items()}
    a, b = flat(resumed.opt_state), flat(unbroken.opt_state)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert resumed.opt_state["count"] == 4


@pytest.mark.parametrize("name,mdt", [("adafactor", None), ("lion", None),
                                      ("lion", "bfloat16")])
def test_new_optimizers_train_tiny_as_jax(name, mdt, jparams, world_of_one):
    """Four clipped steps of the tiny preset (chunked CE) through the
    port's train step against JAX's ``make_train_step`` with the same
    optimizer from ``make_optimizer``. Each step starts from JAX's
    parameters (both updates normalise the gradient, so a 1e-7 gradient
    difference near zero would otherwise compound): the loss, then each
    step's change of every parameter through the converter, adafactor
    per tensor and lion per element apart from its sign ties (lion's
    moment, too, starts each step from JAX's)."""
    tokens = j_data.synthetic_tokens(4096, vocab_size=256, seed=0)
    batcher = j_data.TokenBatcher(tokens, 4, 32, seed=0)
    jmodel = _jax_model()
    tx = j_optim.make_optimizer(name, 1e-3, grad_clip=1.0, moment_dtype=mdt)
    mesh = j_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate = j_dp.init_state(jparams, tx, mesh)
    jstep = j_dp.make_train_step(
        lambda p, b, r: j_llama.loss_fn(jmodel, p, b, r, chunked=True,
                                        chunk_size=16), tx, mesh)
    tmodel = _port_model(jparams)
    opt = t_optim.make_optimizer(name, 1e-3, grad_clip=1.0, moment_dtype=mdt,
                                 layout=t_convert.flax_layout(tmodel.cfg))
    state = t_dp.init_state(dict(tmodel.named_parameters()), opt)
    loss_of = lambda b, g: t_llama.loss_fn(tmodel, b, g, chunked=True,
                                           chunk_size=16)
    train = t_dp.make_train_step(loss_of, opt)
    for i in range(4):
        batch = batcher.batch_at(i)
        start = t_convert.from_flax_params(tmodel.cfg, jstate.params)
        with torch.no_grad():
            for n, p in tmodel.named_parameters():
                p.copy_(start[n])
        if name == "lion":
            # JAX's moment too: a bf16 moment one rounding apart would
            # flip signs well above the tie threshold.
            jmu = t_convert.from_flax_params(tmodel.cfg, jax.tree.map(
                lambda m: np.asarray(m, np.float32),
                jstate.opt_state[1][0].mu))
            for n, m in state.opt_state["mu"].items():
                m.copy_(jmu[n])
            # The gradient the step will take, clipped, for the tie mask.
            loss, _ = loss_of({"tokens": torch.from_numpy(
                batch["tokens"])}, None)
            grads = dict(zip(state.params, torch.autograd.grad(
                loss, list(state.params.values()))))
            norm = float(opt.global_norm(grads))
            mu = {n: state.opt_state["mu"][n].clone() for n in grads}
        state, loss, _ = train(state, batch, i)
        jstate, jloss, _ = jstep(
            jstate, {"tokens": jnp.asarray(batch["tokens"])},
            jax.random.key(i))
        np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
        want = t_convert.from_flax_params(tmodel.cfg, jstate.params)
        for n, p in tmodel.named_parameters():
            got = p.detach().numpy() - start[n].numpy()
            w = want[n].numpy() - start[n].numpy()
            if name == "adafactor":
                assert _change_distance(got, w, 0 * w) <= 1e-4, (i, n)
            else:
                g = grads[n].numpy() * min(1.0, 1.0 / norm)
                _lion_close(got, w, mu[n], g)


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


@pytest.mark.parametrize("dtype,shard_tokens", [("uint8", 1500),
                                                 ("uint16", 2048),
                                                 ("int32", 5000)])
def test_write_token_shards_byte_equal_to_jax(dtype, shard_tokens, tmp_path):
    tokens = j_data.synthetic_tokens(5000, vocab_size=250, seed=4)
    got = t_data.write_token_shards(tokens, str(tmp_path / "t"),
                                    shard_tokens=shard_tokens, dtype=dtype)
    want = j_data.write_token_shards(tokens, str(tmp_path / "j"),
                                     shard_tokens=shard_tokens, dtype=dtype)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()


def _shard_dir(tmp_path):
    """Three raw uint16 shards and one .npy shard, ids below 32000."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32000, size=7000).astype(np.int32)
    d = tmp_path / "shards"
    j_data.write_token_shards(tokens[:6000], str(d), shard_tokens=2100,
                              dtype="uint16")
    np.save(d / "zz_tail.npy", tokens[6000:])
    return str(d), tokens


@pytest.mark.parametrize("hold_out", [0, 300], ids=["all", "held_out"])
@pytest.mark.parametrize("world", [1, 2])
def test_token_shard_batcher_equals_jax(world, hold_out, tmp_path):
    """Every step of two epochs, per process: the same windows as JAX's
    ``TokenShardBatcher`` (memory-mapped raw and .npy shards), the same
    window count, final shard size and held-out tail."""
    d, tokens = _shard_dir(tmp_path)
    for pid in range(world):
        kw = dict(seed=5, process_index=pid, num_processes=world,
                  hold_out_tail=hold_out, vocab_size=32000)
        jb = j_data.TokenShardBatcher(d, 3, 40, **kw)
        tb = t_data.TokenShardBatcher(d, 3, 40, **kw)
        assert tb.num_windows == jb.num_windows
        assert tb.batches_per_epoch == jb.batches_per_epoch
        assert tb.final_shard_tokens == jb.final_shard_tokens == 1000
        for step in range(2 * jb.batches_per_epoch):
            got = tb.batch_at(step)["tokens"]
            assert got.dtype == np.int32 and got.shape == (3, 41)
            np.testing.assert_array_equal(got, jb.batch_at(step)["tokens"])
        if hold_out:
            np.testing.assert_array_equal(tb.tail_tokens(),
                                          tokens[-hold_out:])
            np.testing.assert_array_equal(tb.tail_tokens(),
                                          jb.tail_tokens())
        it = tb.iter_from(7)
        np.testing.assert_array_equal(next(it)["tokens"],
                                      tb.batch_at(7)["tokens"])


def _refusal(fn):
    try:
        fn()
    except (ValueError, FileNotFoundError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no refusal")


def test_token_shard_refusals_equal_jax(tmp_path):
    """Each refusal (vocab range at either end, a shard name without its
    dtype, an empty or too-small directory, a 2-D shard, a tail that eats
    the last shard, writer dtype and range) has JAX's type and message."""
    d, _ = _shard_dir(tmp_path)
    empty = tmp_path / "empty"
    empty.mkdir()
    badname = tmp_path / "badname"
    badname.mkdir()
    np.arange(100, dtype=np.uint16).tofile(badname / "shard_0.float16.bin")
    twod = tmp_path / "twod"
    twod.mkdir()
    np.save(twod / "a.npy", np.zeros((4, 4), np.int32))
    hi = tmp_path / "hi"
    j_data.write_token_shards(np.array([1, 2, 3] * 300 + [999]), str(hi),
                              shard_tokens=500, dtype="uint16")
    cases = [
        lambda m: m.TokenShardBatcher(d, 2, 32, vocab_size=1000),
        lambda m: m.TokenShardBatcher(str(hi), 2, 32, vocab_size=999),
        lambda m: m.TokenShardBatcher(str(badname), 2, 32),
        lambda m: m.TokenShardBatcher(str(empty), 2, 32),
        lambda m: m.TokenShardBatcher(str(twod), 2, 32),
        lambda m: m.TokenShardBatcher(d, 2, 32, hold_out_tail=1000),
        lambda m: m.TokenShardBatcher(d, 2, 5000),
        lambda m: m.TokenShardBatcher(d, 2, 0),
        lambda m: m.TokenShardBatcher(d, 0, 32),
        lambda m: m.TokenShardBatcher(d, 400, 32, num_processes=2),
        lambda m: m.TokenShardBatcher(d, 2, 32).tail_tokens(),
        lambda m: m.write_token_shards(np.arange(5), str(tmp_path / "w"),
                                       dtype="int64"),
        lambda m: m.write_token_shards(np.array([0, 300]),
                                       str(tmp_path / "w"), dtype="uint8"),
    ]
    for i, case in enumerate(cases):
        assert _refusal(lambda: case(t_data)) == \
            _refusal(lambda: case(j_data)), i


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
