"""PyTorch port, ``examples/generate_llama_torch.py``: the train CLI's tiny
preset takes 2 steps on the CPU and writes a checkpoint; the example
restores the newest params from it and generates 16 greedy tokens, equal
to JAX ``generate`` on the same weights (the port's state dict mapped back
onto the flax tree); it refuses a missing checkpoint and a preset that
does not match; it lints clean under graftlint.
"""
import importlib.util
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_distributed_deeplearning_torch.models import convert as t_convert
from k8s_distributed_deeplearning_torch.models import llama as t_llama
from k8s_distributed_deeplearning_torch.train import cli as t_train_cli
from k8s_distributed_deeplearning_torch.train.checkpoint import Checkpointer
from k8s_distributed_deeplearning_tpu.models import generate as j_generate
from k8s_distributed_deeplearning_tpu.models import llama as j_llama

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "examples" / "generate_llama_torch.py"
TINY = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_dim=128, max_seq_len=512)
torch.set_num_threads(2)


def _example():
    spec = importlib.util.spec_from_file_location("generate_llama_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    ck = tmp_path_factory.mktemp("ck")
    with redirect_stdout(io.StringIO()):
        out = t_train_cli.main(["--preset", "tiny", "--device", "cpu",
                                "--num-steps", "2", "--batch-size", "4",
                                "--seq-len", "64", "--checkpoint-dir",
                                str(ck), "--no-eval"])
    assert out["num_steps"] == 2
    return ck


def _to_flax(tcfg, sd):
    """The port's Llama state dict as the unrolled flax params tree
    (the inverse of ``convert.from_flax_params``)."""
    hd = tcfg.resolved_head_dim

    def a(name):
        return sd[name].detach().float().numpy()

    def qkv(w, heads):                     # [H*hd, D] -> [D, H, hd]
        return w.T.reshape(w.shape[1], heads, hd)

    tr = {"tok_embed": {"embedding": a("transformer.tok_embed.weight")},
          "final_norm": {"scale": a("transformer.final_norm.scale")}}
    for i in range(tcfg.n_layers):
        p = f"transformer.blocks.{i}."
        o = a(p + "attn.o_proj.weight")                      # [D, H*hd]
        tr[f"block_{i}"] = {
            "attn_norm": {"scale": a(p + "attn_norm.scale")},
            "mlp_norm": {"scale": a(p + "mlp_norm.scale")},
            "attn": {
                "q_proj": {"kernel": qkv(a(p + "attn.q_proj.weight"),
                                         tcfg.n_heads)},
                "k_proj": {"kernel": qkv(a(p + "attn.k_proj.weight"),
                                         tcfg.resolved_kv_heads)},
                "v_proj": {"kernel": qkv(a(p + "attn.v_proj.weight"),
                                         tcfg.resolved_kv_heads)},
                "o_proj": {"kernel": o.T.reshape(tcfg.n_heads, hd,
                                                 o.shape[0])}},
            "mlp": {w: {"kernel": a(p + f"mlp.{w}.weight").T}
                    for w in ("gate_proj", "up_proj", "down_proj")}}
    params = {"transformer": tr}
    if not tcfg.tie_embeddings:
        params["head"] = {"lm_head": {"kernel": a("head.lm_head.weight").T}}
    return params


@pytest.mark.parametrize("prompt", ["", "graft"], ids=["zero", "bytes"])
def test_example_generates_jax_tokens_from_checkpoint(checkpoint, prompt):
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = _example().main(["--device", "cpu", "--checkpoint-dir",
                               str(checkpoint), "--max-new-tokens", "16",
                               "--prompt", prompt])
    assert got["step"] == 2 and len(got["tokens"]) == 16
    assert "'checkpoint_step': 2" in buf.getvalue()
    tcfg = t_llama.config_tiny(dtype=torch.float32, **TINY)
    model = t_llama.LlamaLM(tcfg, device="cpu")
    params, _ = Checkpointer(str(checkpoint)).restore_params()
    model.load_state_dict(params, strict=False)
    sd = model.state_dict()
    flax = _to_flax(tcfg, sd)
    back = t_convert.from_flax_params(tcfg, flax)
    assert all(torch.equal(back[k], sd[k]) for k in back)
    jcfg = j_llama.config_tiny(dtype=jnp.float32, scan_layers=False, **TINY)
    ids = ([b % 256 for b in prompt.encode()] if prompt else [0])
    want = np.asarray(j_generate.generate(
        j_llama.LlamaLM(jcfg), jax.tree.map(jnp.asarray, flax),
        jnp.asarray([ids], jnp.int32), max_new_tokens=16))[0].tolist()
    assert got["tokens"] == want


def test_example_refusals(checkpoint, tmp_path):
    ex = _example()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ex.main(["--device", "cpu", "--checkpoint-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="do not match --preset"), \
            redirect_stdout(io.StringIO()):
        ex.main(["--device", "cpu", "--checkpoint-dir", str(checkpoint),
                 "--preset", "small"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ex.main(["--checkpoint-dir", str(checkpoint)])


def test_example_lints_clean():
    """graftlint scans ``examples/`` (its default paths): the example
    adds no finding, alone or in the scan set."""
    from k8s_distributed_deeplearning_tpu import analysis
    assert analysis.run([str(EXAMPLE)]).findings == ()
    assert not [f for f in analysis.run().findings
                if f.path.endswith("generate_llama_torch.py")]
