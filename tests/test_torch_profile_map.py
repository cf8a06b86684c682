"""scripts/profile_torch_slice.py attributes the device time of every CUDA
kernel of the port: its OWN_KERNELS map names each `__global__` function of
cruise_control_torch/csrc/*.cu, and nothing else (a name left out would be
counted as PyTorch glue)."""

from __future__ import annotations

import importlib.util
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "cruise_control_torch" / "csrc").glob("*.cu"))


def _kernels(src: pathlib.Path) -> set:
    text = re.sub(r"//[^\n]*", "", src.read_text())
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                          text))


@pytest.fixture(scope="module")
def own_kernels() -> dict:
    spec = importlib.util.spec_from_file_location(
        "profile_torch_slice", ROOT / "scripts" / "profile_torch_slice.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.OWN_KERNELS


@pytest.mark.parametrize("src", SOURCES, ids=[s.stem for s in SOURCES])
def test_every_kernel_of_a_source_is_mapped(own_kernels, src):
    names = _kernels(src)
    assert names, f"{src.name} defines no __global__ function"
    assert names <= set(own_kernels), sorted(names - set(own_kernels))


def test_every_mapped_name_is_a_kernel(own_kernels):
    defined = set().union(*(_kernels(s) for s in SOURCES))
    assert set(own_kernels) <= defined, sorted(set(own_kernels) - defined)
