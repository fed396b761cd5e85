"""kernel_breakdown.py's variants still apply to the sources they edit.

Each variant of the breakdown tool is a list of text substitutions on a
CUDA source; a source edit that moves one of those texts makes the tool
refuse to build on the card. These tests catch that here, on the CPU,
and check that the decode breakdown's launches are shapes of the decode
route, a row-tiled verify window among them. They also hold each ctypes
binding of a C entry point, the breakdown's and the paged wrapper's,
to the entry point's declaration in its source: an argument added on
one side alone would pass garbage on the card.
"""
import ctypes
import importlib.util
import re
import types
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
_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _c_argtypes(source: str, name: str) -> list:
    """The ctypes argument types of ``extern "C" int name(...)`` in the
    source ``source``: a pointer is c_void_p, int and float their own."""
    src = (_build.CSRC_DIR / source).read_text()
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    assert found, f"{name} is not declared in {source}"
    return [ctypes.c_void_p if "*" in p else _C_TYPES[p.split()[0]]
            for p in (a.strip() for a in found.group(1).split(","))]


class _Library:
    """Stands in for a ctypes library: records what a binding sets."""

    def __init__(self):
        self.bound = {}

    def __getattr__(self, name):
        if name.startswith("_") or name == "bound":
            raise AttributeError(name)
        return self.bound.setdefault(
            name, types.SimpleNamespace(argtypes=None, restype=None))


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


@pytest.mark.parametrize("name", list(kernel_breakdown.PAGED_F32_LAUNCHES))
def test_paged_f32_launches_take_the_tf32x3_route(name):
    """Every launch the f32 paged breakdown times is a shape the tf32x3
    route takes, with its queries' positions inside its table."""
    lens, sq, n_blocks = kernel_breakdown.PAGED_F32_LAUNCHES[name]
    h, kv, hd = kernel_breakdown.DECODE_HEADS
    assert paged_attn._route(sq, h // kv, hd, torch.float32,
                             False) == "tf32x3"
    assert sq <= min(lens) and max(lens) <= n_blocks * 32


@pytest.mark.parametrize("dtype,name", [
    (torch.bfloat16, n) for n in kernel_breakdown.PAGED_SMALL_LAUNCHES] + [
    (torch.float32, n) for n in kernel_breakdown.PAGED_SMALL_F32_LAUNCHES])
def test_paged_small_launches_take_their_tensor_core_route(dtype, name):
    """Every launch the head-dim-16 breakdowns time is a shape that the
    route of its kernel takes (bf16: decode; f32: tf32x3), with its
    queries' positions inside its table."""
    launches = (kernel_breakdown.PAGED_SMALL_LAUNCHES
                if dtype == torch.bfloat16
                else kernel_breakdown.PAGED_SMALL_F32_LAUNCHES)
    h, kv, lens, sq, n_blocks = launches[name]
    assert paged_attn._route(sq, h // kv, kernel_breakdown.SMALL_HEAD_DIM,
                             dtype, False) == (
        "decode" if dtype == torch.bfloat16 else "tf32x3")
    assert sq <= min(lens) and max(lens) <= n_blocks * 32


@pytest.mark.parametrize("name", list(kernel_breakdown.TGMM_F32_LAUNCHES))
def test_tgmm_f32_launches_are_phase_g_layouts(name):
    """The weight-gradient breakdown's layouts hold 16,384 rows over 8
    experts, and the skewed and one-expert ones leave an expert empty."""
    kind, k, n = kernel_breakdown.TGMM_F32_LAUNCHES[name]
    sizes = kernel_breakdown._gmm_sizes(kind)
    assert len(sizes) == 8 and sum(sizes) == 16384
    assert (0 in sizes) == (kind != "router") and k % 8 == n % 8 == 0


@pytest.mark.parametrize("kernel", list(kernel_breakdown.KERNELS))
def test_breakdown_bindings_match_the_c_entry_points(kernel):
    spec = kernel_breakdown.KERNELS[kernel]
    lib = _Library()
    spec.bind(lib)
    assert lib.bound
    for name, fn in lib.bound.items():
        assert fn.argtypes == _c_argtypes(spec.source, name), name
        assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("library,entry", [
    (lib, entry) for lib, entries in paged_attn._SIGNATURES.items()
    for entry in entries])
def test_paged_wrapper_signatures_match_the_c_entry_points(library, entry):
    args, result = paged_attn._SIGNATURES[library][entry]
    assert list(args) == _c_argtypes(f"{library}.cu", entry)
    assert result is ctypes.c_int
