"""kernel_breakdown.py's variants still apply to the sources they edit.

Each variant of the breakdown tool is a list of text substitutions on a
CUDA source; a source edit that moves one of those texts makes the tool
refuse to build on the card. These tests catch that here, on the CPU,
and check that the decode breakdown's launches are shapes of the decode
route, a row-tiled verify window among them.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from k8s_distributed_deeplearning_torch.ops import _build, paged_attn

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "kernel_breakdown", REPO / "kernel_breakdown.py")
kernel_breakdown = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kernel_breakdown)

CASES = [(kernel, variant)
         for kernel, spec in kernel_breakdown.KERNELS.items()
         for variant in spec.variants]


@pytest.mark.parametrize("kernel,variant", CASES,
                         ids=[f"{k}-{v}" for k, v in CASES])
def test_variant_substitutions_match_the_source(kernel, variant):
    spec = kernel_breakdown.KERNELS[kernel]
    src = (_build.CSRC_DIR / spec.source).read_text()
    for old, new, count in spec.variants[variant]:
        assert src.count(old) == count, old
        assert old != new


def test_every_kernel_has_a_base_variant():
    for spec in kernel_breakdown.KERNELS.values():
        assert spec.variants["base"] == []


@pytest.mark.parametrize("name", list(kernel_breakdown.DECODE_LAUNCHES))
def test_decode_launches_take_the_decode_route(name):
    """Every launch the decode breakdown times is a shape the decode route
    takes, with its queries' positions inside the 64-block table."""
    lens, sq = kernel_breakdown.DECODE_LAUNCHES[name]
    h, kv, hd = kernel_breakdown.DECODE_HEADS
    assert paged_attn._route(sq, h // kv, hd, torch.bfloat16,
                             False) == "decode"
    assert len(lens) == 4 and sq <= min(lens) and max(lens) <= 64 * 32


def test_decode_breakdown_times_a_row_tiled_window():
    """The breakdown covers the verify window's launch: more than one
    16-row tile a KV head."""
    h, kv, _ = kernel_breakdown.DECODE_HEADS
    rows = [sq * (h // kv)
            for _, sq in kernel_breakdown.DECODE_LAUNCHES.values()]
    assert max(rows) > paged_attn._DECODE_TILE_ROWS
