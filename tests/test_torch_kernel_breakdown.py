"""kernel_breakdown.py's variants still apply to the sources they edit.

Each variant of the breakdown tool is a list of text substitutions on a
CUDA source; a source edit that moves one of those texts makes the tool
refuse to build on the card. These tests catch that here, on the CPU.
"""
import importlib.util
from pathlib import Path

import pytest

from k8s_distributed_deeplearning_torch.ops import _build

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
