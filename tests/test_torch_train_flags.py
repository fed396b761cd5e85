"""PyTorch port, the train CLI's layout and the JAX scripts' flags.

- ``--preset small`` trains on JAX's unrolled layout: the CLI hands the
  optimizer ``flax_layout(scan_layers=False)`` (the JAX preset's
  ``scan_layers=False``), and one adafactor step with that layout equals
  optax's on JAX's unrolled tree (small's head_dim at reduced dims);
  ``--scan-layers`` / ``--no-scan-layers`` override the preset.
- Every flag of ``examples/train_llama.py`` and
  ``examples/generate_llama.py`` parses in the port's train CLI and
  ``examples/generate_llama_torch.py``; the unported ones (pipeline,
  sharded and context-parallel training) raise by name, naming
  ROADMAP.md.
"""
import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.train import cli as t_cli
from k8s_distributed_deeplearning_torch.train import optim as t_optim
from k8s_distributed_deeplearning_tpu.models import llama as j_llama
from k8s_distributed_deeplearning_tpu.train import optim as j_optim

REPO = Path(__file__).resolve().parents[1]
# Small's head_dim (768 / 12) at reduced width and depth; every kernel is
# factored (dims >= 128).
REDUCED = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
               mlp_dim=512, max_seq_len=64)
CHANGE_TOL = 1e-4        # ||port - optax|| / ||optax step||, per tensor


class _Caught(Exception):
    pass


def _captured_layout(argv, monkeypatch):
    """The ``layout`` the train CLI hands ``make_optimizer`` for
    ``argv`` (the run stops there)."""
    seen = {}

    def catch(name, *a, layout=None, **kw):
        seen.update(name=name, layout=layout)
        raise _Caught

    with monkeypatch.context() as m:
        m.setattr(t_cli.optim, "make_optimizer", catch)
        with pytest.raises(_Caught):
            t_cli.main(argv + ["--device", "cpu", "--num-steps", "1"])
    return seen


def _change_distance(got, want, start):
    return (np.linalg.norm(got - want)
            / max(np.linalg.norm(want - start), 1e-30))


def _step(layout, jp, jg):
    """One adafactor step on the port's converted params with
    ``layout``."""
    tcfg = t_llama.config_tiny(dtype=torch.float32, **REDUCED)
    tp = {k: v.clone() for k, v in t_convert.from_flax_params(
        tcfg, jp).items()}
    opt = t_optim.make_optimizer("adafactor", 0.01, grad_clip=1.0,
                                 layout=layout)
    opt.apply(tp, t_convert.from_flax_params(tcfg, jg), opt.init(tp))
    return tp


def test_small_preset_trains_on_the_unrolled_layout(monkeypatch):
    seen = _captured_layout(["--preset", "small", "--optimizer",
                             "adafactor"], monkeypatch)
    layout = seen["layout"]
    assert seen["name"] == "adafactor"
    name = "transformer.blocks.3.attn.q_proj.weight"
    assert layout(name)[:2] == ("transformer/block_3/attn/q_proj/kernel",
                                False)
    # One step against optax on JAX's unrolled tree.
    jcfg = j_llama.config_tiny(dtype=jnp.float32, scan_layers=False,
                               **REDUCED)
    jp = j_llama.LlamaLM(jcfg).init(jax.random.key(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(3)
    jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        np.shape(x)).astype(np.float32)), jp)
    tx = j_optim.make_optimizer("adafactor", 0.01, grad_clip=1.0)
    upd, _ = tx.update(jg, tx.init(jp), jp)
    tcfg = t_llama.config_tiny(dtype=torch.float32, **REDUCED)
    want = t_convert.from_flax_params(tcfg, optax.apply_updates(jp, upd))
    start = t_convert.from_flax_params(tcfg, jp)
    got = _step(layout, jp, jg)
    for k in got:
        assert _change_distance(got[k].numpy(), want[k].numpy(),
                                start[k].numpy()) <= CHANGE_TOL, k
    # The scanned layout (what the CLI passed before) is another step.
    scanned = _step(t_convert.flax_layout(tcfg, scan_layers=True), jp, jg)
    assert max(_change_distance(scanned[k].numpy(), want[k].numpy(),
                                start[k].numpy()) for k in got) > CHANGE_TOL


@pytest.mark.parametrize("argv,unrolled", [
    (["--preset", "small"], True),
    (["--preset", "small", "--scan-layers"], False),
    (["--preset", "tiny"], False),
    (["--preset", "tiny", "--no-scan-layers"], True)])
def test_scan_layers_flags_override_the_preset(argv, unrolled):
    args = t_cli.parse_args(argv)
    assert t_cli.scan_layers(args) is (not unrolled)
    leaf = t_convert.flax_layout(
        t_cli.build_config(args), scan_layers=t_cli.scan_layers(args))(
        "transformer.blocks.1.mlp.up_proj.weight")[0]
    assert leaf == ("transformer/block_1/mlp/up_proj/kernel" if unrolled
                    else "transformer/blocks/mlp/up_proj/kernel")


def _parser_of(main, monkeypatch):
    seen = {}

    def catch(self, *a, **kw):
        seen["parser"] = self
        raise _Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Caught):
            main([])
    return seen["parser"]


def _flags(parser) -> dict:
    return {opt: act for act in parser._actions for opt in act.option_strings
            if opt.startswith("--") and opt != "--help"}


def _load(path: Path, monkeypatch):
    monkeypatch.syspath_prepend(str(path.parent))
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(flag, act):
    if act.nargs == 0:
        return [flag]
    samples = {int: "2", float: "0.5", None: "x"}
    value = act.choices[-1] if act.choices else samples.get(act.type, "x")
    return [flag, str(value)]


@pytest.mark.parametrize("script", ["train_llama", "generate_llama"])
def test_every_jax_flag_parses_in_the_port(script, monkeypatch):
    """Every flag of the JAX script is declared by the port's and parses
    there (argparse exits 2 on an unknown one)."""
    j_main = _load(REPO / "examples" / f"{script}.py", monkeypatch).main
    if script == "train_llama":
        t_main = t_cli.main
    else:
        t_main = _load(REPO / "examples" / "generate_llama_torch.py",
                       monkeypatch).main
    j_flags = _flags(_parser_of(j_main, monkeypatch))
    t_parser = _parser_of(t_main, monkeypatch)
    assert set(j_flags) <= set(_flags(t_parser)), sorted(
        set(j_flags) - set(_flags(t_parser)))
    for flag, act in sorted(j_flags.items()):
        t_parser.parse_args(_argv(flag, act))


@pytest.mark.parametrize("argv", [
    ["--pp", "2"], ["--pp-microbatches", "4"], ["--pp-schedule", "1f1b"],
    ["--pp-virtual", "2"], ["--attention", "ring"],
    ["--attention", "ulysses"], ["--fsdp", "2"], ["--tp", "2"],
    ["--sp", "2"], ["--ep", "2"]], ids=lambda a: "=".join(a))
def test_unported_train_flags_raise_by_name(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        t_cli.main(argv + ["--device", "cpu"])
    assert argv[0] in str(err.value)


def test_generate_accepts_remat(tmp_path, monkeypatch):
    """``--remat`` parses in the port's generate example (no effect on
    decode); the run then stops at the missing checkpoint."""
    mod = _load(REPO / "examples" / "generate_llama_torch.py", monkeypatch)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mod.main(["--remat", "--device", "cpu", "--checkpoint-dir",
                  str(tmp_path)])
