"""PyTorch port, mixture of experts (``models/moe.py``) against the JAX
package's ``models/moe.py`` on the same numpy-seeded inputs and the same
weights: the routing functions, every ``MoEMLP`` dispatch and its decode
branch, ``MoELM`` logits, loss and every gradient through the converter
(scanned and unrolled trees), the remat policies, a one-replica ragged
train step against JAX's ``make_train_step``, and the training CLI.

The JAX ragged path runs ``pallas_gmm`` in interpret mode on the CPU; the
port's grouped matmul takes its plain versions on CPU tensors. Config:
``config_tiny`` (dim 64, mlp 128, 2 layers) in float32 with f32 params,
4 experts, top-2, ``ragged_block_m`` 8. Tolerances: routing indices and
keep sets exact, gates 1e-6; layer outputs and aux values 1e-5; losses
1e-5; gradients 1e-5 absolute / 1e-4 relative (f32 on both sides, sums in
different orders; observed ~1e-7).
"""
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.models import moe as t_moe
from k8s_distributed_deeplearning_torch.ops import gmm as t_gmm
from k8s_distributed_deeplearning_torch.parallel import (
    data_parallel as t_dp)
from k8s_distributed_deeplearning_torch.parallel import distributed as t_dist
from k8s_distributed_deeplearning_torch.train import cli as t_cli
from k8s_distributed_deeplearning_torch.train import optim as t_optim
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.models import moe as j_moe
from k8s_distributed_deeplearning_tpu.parallel import data_parallel as j_dp
from k8s_distributed_deeplearning_tpu.parallel import mesh as j_mesh
from k8s_distributed_deeplearning_tpu.train import optim as j_optim

OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)

torch.set_num_threads(2)


def _mcfgs(**kw):
    base = dict(num_experts=4, top_k=2, ragged_block_m=8)
    base.update(kw)
    return j_moe.MoEConfig(**base), t_moe.MoEConfig(**base)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


# ------------------------------------------------------------- routing


def _logits(case):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    if case == "adversarial":            # every token prefers expert 0
        x = 0.01 * x
        x[:, 0] += 3.0
    return x


@pytest.mark.parametrize("case", ["random", "adversarial"])
@pytest.mark.parametrize("capacity", [6, 40])
def test_top_k_routing_matches_jax_exactly(case, capacity):
    """Index and dense top-k routing: the same destinations, keep sets and
    dispatch masks, the same gates, combine weights and aux values."""
    x = _logits(case)
    jd, jg, jk, ja = j_moe.top_k_dispatch_indices(jnp.asarray(x), 2,
                                                  capacity)
    td, tg, tk, ta = t_moe.top_k_dispatch_indices(torch.from_numpy(x), 2,
                                                  capacity)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), atol=1e-6, rtol=1e-6)
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), **OUT_TOL)
    jdisp, jcomb, ja = j_moe.top_k_routing(jnp.asarray(x), 2, capacity)
    tdisp, tcomb, ta = t_moe.top_k_routing(torch.from_numpy(x), 2, capacity)
    np.testing.assert_array_equal(_np(tdisp), np.asarray(jdisp))
    np.testing.assert_allclose(_np(tcomb), np.asarray(jcomb), atol=1e-6,
                               rtol=1e-6)
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), **OUT_TOL)
    if case == "adversarial" and capacity == 6:
        assert float(ta["fraction_dropped"]) > 0.5


@pytest.mark.parametrize("capacity", [5, 16])
def test_expert_choice_routing_matches_jax_exactly(capacity):
    x = _logits("random")
    jdisp, jcomb, ja = j_moe.expert_choice_routing(jnp.asarray(x), capacity)
    tdisp, tcomb, ta = t_moe.expert_choice_routing(torch.from_numpy(x),
                                                   capacity)
    np.testing.assert_array_equal(_np(tdisp), np.asarray(jdisp))
    np.testing.assert_allclose(_np(tcomb), np.asarray(jcomb), atol=1e-6,
                               rtol=1e-6)
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), **OUT_TOL)


def test_config_validation_and_capacity_clamp():
    with pytest.raises(ValueError, match="expert choice"):
        t_moe.MoEConfig(routing="expert_choice", dispatch="ragged")
    with pytest.raises(ValueError, match="dispatch"):
        t_moe.MoEConfig(dispatch="sorted")
    for t in (2, 7, 64, 4096):
        for cf in (0.5, 1.25, 3.0):
            jm, tm = _mcfgs(capacity_factor=cf)
            assert t_moe.clamped_capacity(t, tm) == j_moe.clamped_capacity(
                t, jm)


# ------------------------------------------------------------- MoEMLP


def _layer_pair(mcfg_j, mcfg_t, seed=0):
    jcfg = j_llama.config_tiny(dtype=jnp.float32)
    tcfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32)
    jlayer = j_moe.MoEMLP(jcfg, mcfg_j)
    params = jlayer.init(jax.random.key(seed),
                         jnp.zeros((1, 8, jcfg.dim)))["params"]
    tlayer = t_moe.MoEMLP(tcfg, mcfg_t, device="cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(tlayer, name).copy_(torch.from_numpy(np.array(
                params[name].unbox() if hasattr(params[name], "unbox")
                else params[name])))
    return jlayer, params, tlayer


def _x(b, s, seed=3):
    return np.random.default_rng(seed).standard_normal((b, s, 64)).astype(
        np.float32)


LAYER_CASES = [("topk", "index", 1.0), ("topk", "einsum", 1.0),
               ("topk", "ragged", 1.25), ("expert_choice", "index", 1.0),
               ("expert_choice", "einsum", 1.0), ("topk", "index", 100.0)]


@pytest.mark.parametrize("routing,dispatch,cf", LAYER_CASES,
                         ids=lambda c: str(c))
def test_moe_mlp_dispatch_matches_jax(routing, dispatch, cf):
    """Each dispatch on the same weights and tokens: the output and every
    aux value JAX sows (capacity_factor 1.0 forces drops on the capacity
    paths)."""
    mj, mt = _mcfgs(routing=routing, dispatch=dispatch, capacity_factor=cf)
    jlayer, params, tlayer = _layer_pair(mj, mt)
    x = _x(4, 16)
    jy, state = jax.jit(lambda p, xx: jlayer.apply(
        {"params": p}, xx, mutable=["intermediates"]))(params, jnp.asarray(x))
    collector = t_moe.AuxCollector()
    ty = tlayer(torch.from_numpy(x), aux=collector)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **OUT_TOL)
    jaux = {k: float(v[0]) for k, v in state["intermediates"].items()}
    taux = collector.layers[tlayer]
    assert sorted(taux) == sorted(jaux)
    for k, v in jaux.items():
        np.testing.assert_allclose(float(taux[k].detach()), v, **OUT_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("dispatch,seq", [("index", 16), ("ragged", 16),
                                          ("ragged", 80)],
                         ids=["index", "ragged-narrow", "ragged-wide"])
def test_moe_mlp_decode_branch_matches_jax(dispatch, seq):
    """decode=True: the dropless per-token path, on the index path at
    capacity = T for narrow calls and on the grouped matmuls for calls of
    128 tokens or more (2 x 80 here); it records no aux values."""
    mj, mt = _mcfgs(dispatch=dispatch, capacity_factor=1.0)
    jlayer, params, tlayer = _layer_pair(mj, mt, seed=1)
    x = _x(2, seq, seed=4)
    jy = jax.jit(lambda p, xx: jlayer.apply({"params": p}, xx, decode=True))(
        params, jnp.asarray(x))
    collector = t_moe.AuxCollector()
    ty = tlayer(torch.from_numpy(x), decode=True, aux=collector)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **OUT_TOL)
    assert not collector.layers


def test_ragged_layer_gradients_match_jax():
    """The ragged layer's input and weight gradients, through the gmm
    autograd, against jax.grad through the Pallas custom_vjp, with the aux
    losses in the objective."""
    mj, mt = _mcfgs(dispatch="ragged")
    jlayer, params, tlayer = _layer_pair(mj, mt, seed=2)
    x = _x(2, 16, seed=5)
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)

    def jf(p, xx):
        y, st = jlayer.apply({"params": p}, xx, mutable=["intermediates"])
        lb = st["intermediates"]["load_balance_loss"][0]
        return jnp.sum(y * cot) + lb

    jgp, jgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(params,
                                                      jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    collector = t_moe.AuxCollector()
    y = tlayer(tx, aux=collector)
    ((y * torch.from_numpy(cot)).sum()
     + collector.total("load_balance_loss")).backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), **GRAD_TOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        want = jgp[name]
        want = want.unbox() if hasattr(want, "unbox") else want
        np.testing.assert_allclose(_np(getattr(tlayer, name).grad),
                                   np.asarray(want), err_msg=name,
                                   **GRAD_TOL)


# ------------------------------------------------------------- MoELM


def _jax_lm(mcfg, **kw):
    kw.setdefault("dtype", jnp.float32)
    return j_moe.MoELM(j_llama.config_tiny(**kw), mcfg)


def _port_lm(params, mcfg, **kw):
    cfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32,
                              **kw)
    model = t_moe.MoELM(cfg, mcfg, device="cpu")
    model.load_state_dict(t_convert.from_flax_params(cfg, params))
    return model


def _tokens(seed, b=4, s=17):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["unchunked", "chunked"])
def test_moe_lm_loss_logits_and_every_gradient_match_jax(scan, chunked):
    """Ragged MoELM through the converter: logits, the loss (CE plus aux)
    and its parts, and every parameter's gradient."""
    mj, mt = _mcfgs(dispatch="ragged")
    jmodel = _jax_lm(mj, scan_layers=scan)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tokens = _tokens(1)
    kw = dict(chunked=chunked, chunk_size=16)
    (want, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_moe.loss_fn(jmodel, mj, p,
                                {"tokens": jnp.asarray(tokens)}, **kw),
        has_aux=True))(params)
    tmodel = _port_lm(params, mt)
    loss, aux = t_moe.loss_fn(tmodel, mt,
                              {"tokens": torch.from_numpy(tokens)}, **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **OUT_TOL)
    for k in ("ce", "aux_loss", "accuracy"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), **OUT_TOL,
                                   err_msg=k)
    want_grads = t_convert.from_flax_params(tmodel.cfg, jgrads)
    assert sorted(want_grads) == sorted(n for n, _ in
                                        tmodel.named_parameters())
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want_grads[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    if not chunked:
        jlogits = jax.jit(lambda p: jmodel.apply({"params": p},
                                                 jnp.asarray(tokens)))(params)
        with torch.no_grad():
            tlogits = tmodel(torch.from_numpy(tokens))
        np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits),
                                   **OUT_TOL)


def test_ragged_equals_dropless_index_in_the_port():
    """JAX's test_ragged_dispatch_matches_dropless_index, in the port: the
    ragged path and the index path at a capacity that drops nothing give
    the same loss, aux loss and gradients from the same weights."""
    _, mr = _mcfgs(dispatch="ragged")
    _, mi = _mcfgs(dispatch="index", capacity_factor=100.0)
    cfg = t_llama.config_tiny(dtype=torch.float32, param_dtype=torch.float32)
    batch = {"tokens": torch.from_numpy(_tokens(3, s=16))}
    got = {}
    for name, mcfg in (("ragged", mr), ("index", mi)):
        model = t_moe.MoELM(cfg, mcfg, device="cpu", seed=1)
        loss, aux = t_moe.loss_fn(model, mcfg, batch)
        loss.backward()
        got[name] = (loss, aux, dict(model.named_parameters()))
    torch.testing.assert_close(got["ragged"][0], got["index"][0], rtol=2e-5,
                               atol=0)
    torch.testing.assert_close(got["ragged"][1]["aux_loss"],
                               got["index"][1]["aux_loss"], rtol=2e-5, atol=0)
    for name, p in got["ragged"][2].items():
        torch.testing.assert_close(p.grad, got["index"][2][name].grad,
                                   rtol=2e-4, atol=2e-5, msg=name)


@pytest.mark.parametrize("policy,gmm_calls", [("dots", 6), ("dots_attn", 6),
                                              ("nothing", 9)])
def test_remat_policies_keep_gradients_and_count_grouped_matmuls(
        monkeypatch, policy, gmm_calls):
    """Each remat policy gives the loss and every gradient of the model
    without remat, counts each layer's aux losses once, and runs per layer
    3 forward grouped matmuls (again in the backward unless the policy
    saves them), 3 dlhs products and 3 tgmm."""
    calls = {"gmm": 0, "tgmm": 0}
    fwd, tg = t_gmm.gmm_forward, t_gmm.tgmm

    def count_gmm(*a, **kw):
        calls["gmm"] += 1
        return fwd(*a, **kw)

    def count_tgmm(*a, **kw):
        calls["tgmm"] += 1
        return tg(*a, **kw)

    monkeypatch.setattr(t_gmm, "gmm_forward", count_gmm)
    monkeypatch.setattr(t_gmm, "tgmm", count_tgmm)
    _, mt = _mcfgs(dispatch="ragged")
    batch = {"tokens": torch.from_numpy(_tokens(4, s=16))}
    got = {}
    for remat in (False, True):
        cfg = t_llama.config_tiny(dtype=torch.float32,
                                  param_dtype=torch.float32, remat=remat,
                                  remat_policy=policy)
        model = t_moe.MoELM(cfg, mt, device="cpu", seed=2)
        calls.update(gmm=0, tgmm=0)
        loss, aux = t_moe.loss_fn(model, mt, batch, chunked=True,
                                  chunk_size=16)
        loss.backward()
        got[remat] = (loss.detach(), aux["aux_loss"].detach(),
                      dict(model.named_parameters()), dict(calls))
    n_layers = cfg.n_layers
    assert got[False][3] == {"gmm": 6 * n_layers, "tgmm": 3 * n_layers}
    assert got[True][3] == {"gmm": gmm_calls * n_layers,
                            "tgmm": 3 * n_layers}
    torch.testing.assert_close(got[True][0], got[False][0], atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(got[True][1], got[False][1], atol=1e-7,
                               rtol=1e-6)
    for name, p in got[True][2].items():
        torch.testing.assert_close(p.grad, got[False][2][name].grad,
                                   atol=1e-6, rtol=1e-6, msg=name)


def test_expert_choice_lm_warns_at_construction():
    _, mt = _mcfgs(routing="expert_choice", capacity_factor=2.0)
    with pytest.warns(UserWarning, match="non-causal"):
        t_moe.MoELM(t_llama.config_tiny(n_layers=1), mt, device="cpu")


def test_expert_init_folds_the_expert_axis_into_the_fans():
    """Glorot-uniform limits as flax computes them on the 3-D shapes:
    sqrt(6 / ((d + m) E)) for the experts, sqrt(6 / (d + E)) for the
    router."""
    _, mt = _mcfgs()
    layer = t_moe.MoELM(t_llama.config_tiny(n_layers=1), mt,
                        device="cpu").transformer.blocks[0].mlp
    for name, limit in (("w_gate", (6 / ((64 + 128) * 4)) ** 0.5),
                        ("w_down", (6 / ((128 + 64) * 4)) ** 0.5),
                        ("router", (6 / (64 + 4)) ** 0.5)):
        w = getattr(layer, name).detach()
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.9 * limit, name
    assert layer.router.dtype == torch.float32


@pytest.mark.parametrize("kw", [dict(dispatch="ragged"), dict(),
                                dict(routing="expert_choice",
                                     capacity_factor=1.5)],
                         ids=["ragged", "index", "expert_choice"])
def test_flops_per_token_matches_jax(kw):
    mj, mt = _mcfgs(**kw)
    jcfg, tcfg = j_llama.config_tiny(), t_llama.config_tiny()
    for extra in (dict(), dict(seq_len=64), dict(tokens_per_batch=4096),
                  dict(tokens_per_batch=2)):
        assert t_moe.flops_per_token(tcfg, mt, **extra) == pytest.approx(
            j_moe.flops_per_token(jcfg, mj, **extra), rel=1e-12)


# ------------------------------------------------------------- training


@pytest.fixture
def world_of_one():
    t_dist.initialize_single("cpu")
    yield
    t_dist.shutdown()


def test_ragged_train_step_matches_jax_one_replica(world_of_one):
    """Two AdamW steps (clip 1.0, chunked CE) of the ragged MoE LM through
    the port's make_train_step on a gloo world of one, against JAX's
    make_train_step on a 1-device mesh: the losses, then every parameter
    through the converter."""
    mj, mt = _mcfgs(dispatch="ragged")
    jmodel = _jax_lm(mj, scan_layers=False)
    params = jmodel.init(jax.random.key(5),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    batches = [{"tokens": _tokens(10 + i, b=4, s=17)} for i in range(2)]
    tx = j_optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    mesh = j_mesh.make_mesh({"data": 1}, devices=jax.devices()[:1])
    jstate = j_dp.init_state(params, tx, mesh)
    jstep = j_dp.make_train_step(
        lambda p, b, r: j_moe.loss_fn(jmodel, mj, p, b, r, chunked=True,
                                      chunk_size=16), tx, mesh)
    jlosses = []
    for i, b in enumerate(batches):
        jstate, loss, _ = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])},
                                jax.random.key(i))
        jlosses.append(float(loss))

    tmodel = _port_lm(params, mt)
    opt = t_optim.make_optimizer("adamw", 1e-3, grad_clip=1.0)
    state = t_dp.init_state(dict(tmodel.named_parameters()), opt)
    step = t_dp.make_train_step(
        lambda b, g: t_moe.loss_fn(tmodel, mt, b, g, chunked=True,
                                   chunk_size=16), opt)
    losses = []
    for i, b in enumerate(batches):
        state, loss, aux = step(state, b, i)
        losses.append(float(loss))
    assert set(aux) == {"ce", "aux_loss", "accuracy"}
    np.testing.assert_allclose(losses, jlosses, **OUT_TOL)
    want = t_convert.from_flax_params(tmodel.cfg, jstate.params)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(_np(p), want[name].numpy(), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


def test_cli_trains_ragged_moe_on_cpu(tmp_path):
    """python -m k8s_distributed_deeplearning_torch.train --preset tiny
    --moe-experts 4 --moe-dispatch ragged --device cpu: the start event
    names the MoE layer and the loss falls. The checkpoints go to a fresh
    directory: the CLI restores from the one it is given."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        t_cli.main(["--preset", "tiny", "--moe-experts", "4",
                    "--moe-dispatch", "ragged", "--device", "cpu",
                    "--num-steps", "10", "--batch-size", "4", "--seq-len",
                    "32", "--lr", "3e-3", "--log-every", "1", "--no-eval",
                    "--checkpoint-dir", str(tmp_path / "ck")])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    start = events[0]
    assert start["event"] == "start"
    assert start["moe"] == {"experts": 4, "top_k": 2,
                            "capacity_factor": 1.25, "dispatch": "ragged"}
    losses = [e["loss"] for e in events if e["event"] == "train_step"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0]


def test_cli_refuses_expert_parallelism():
    with pytest.raises(NotImplementedError, match="--ep 2"):
        t_cli.main(["--preset", "tiny", "--moe-experts", "4", "--ep", "2",
                    "--device", "cpu"])
