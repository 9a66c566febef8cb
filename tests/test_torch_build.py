"""The port's kernel build keys and packaging, on the CPU (no ``nvcc``):
a library is keyed by its ``.cu`` and every local header it includes, so
an edited shared header rebuilds every kernel that includes it, and the
headers ship with the package.  Also which tensors the tensor-core
kernels may stage by 16-byte copies."""

import re
import shutil
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build, _layout

REPO = Path(__file__).resolve().parents[1]
KERNELS = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
TENSOR_CORE = {"flash_attention", "matmul_requant", "moe_gmm"}  # the sources that include mma_sm90.cuh


@pytest.fixture
def csrc_copy(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    return dst


def test_every_kernel_is_keyed_and_the_shared_header_is_seen():
    # the six kernels, and the empty kernel that chip_smoke.py times as the launch floor
    assert set(KERNELS) == {"conv_requant", "flash_attention", "launch_floor", "matmul_requant", "moe_gmm",
                            "rglru_scan", "ssd_scan"}
    for name in KERNELS:
        deps = {p.name for p in _build.local_includes(_build.CSRC / f"{name}.cu")}
        assert deps == ({"mma_sm90.cuh"} if name in TENSOR_CORE else set()), name
        assert re.fullmatch(r"[0-9a-f]{16}", _build.digest(name))


def test_digest_of_an_unchanged_tree_is_unchanged(csrc_copy):
    for name in KERNELS:
        assert _build.digest(name, csrc_copy) == _build.digest(name)
        assert _build.digest(name, csrc_copy) == _build.digest(name, csrc_copy)


def test_editing_the_shared_header_changes_the_digest_of_every_includer(csrc_copy):
    before = {name: _build.digest(name, csrc_copy) for name in KERNELS}
    header = csrc_copy / "mma_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.digest(name, csrc_copy) for name in KERNELS}
    changed = {name for name in KERNELS if after[name] != before[name]}
    assert changed == TENSOR_CORE


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm", "matmul_requant"])
def test_editing_a_source_changes_only_its_digest(csrc_copy, name):
    before = {n: _build.digest(n, csrc_copy) for n in KERNELS}
    src = csrc_copy / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert {n for n in KERNELS if _build.digest(n, csrc_copy) != before[n]} == {name}


def test_nested_local_includes_are_followed(tmp_path):
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n#include <cstdint>\n')
    (tmp_path / "b.cuh").write_text("// leaf\n")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n  #  include "b.cuh"\n')
    assert [p.name for p in _build.local_includes(tmp_path / "k.cu")] == ["a.cuh", "b.cuh"]
    before = _build.digest("k", tmp_path)
    (tmp_path / "b.cuh").write_text("// leaf, edited\n")
    assert _build.digest("k", tmp_path) != before


def test_package_data_ships_every_csrc_file():
    text = (REPO / "pyproject.toml").read_text()
    m = re.search(r"^\[tool\.setuptools\.package-data\]\s*\nrepro_torch\s*=\s*\[([^\]]*)\]", text, re.MULTILINE)
    assert m, "pyproject.toml names no package data for repro_torch"
    patterns = re.findall(r'"([^"]+)"', m.group(1))
    assert "kernels/csrc/*.cuh" in patterns and "kernels/csrc/*.cu" in patterns
    pkg = _build.CSRC.parents[1]
    shipped = {p for pat in patterns for p in pkg.glob(pat)}
    assert set(_build.CSRC.iterdir()) - {_build.CSRC / "__pycache__"} <= shipped


def test_rows_16b_aligned():
    buf = torch.zeros(4 * 8 * 64 + 8, dtype=torch.bfloat16)
    x = buf[: 4 * 8 * 64].view(4, 8, 64)
    assert _layout.rows_16b_aligned(x)
    assert _layout.rows_16b_aligned(x.transpose(0, 1))  # strides 64 and 512 elements: 128 and 1024 bytes
    assert not _layout.rows_16b_aligned(buf[1 : 1 + 4 * 8 * 64].view(4, 8, 64))  # base one element off
    assert not _layout.rows_16b_aligned(x[..., :60])  # rows of 120 bytes
    assert not _layout.rows_16b_aligned(x.transpose(1, 2))  # last dim not unit-stride
    assert not _layout.rows_16b_aligned(buf[: 4 * 8 * 60].view(4, 8, 60)[:, :, :56])  # row stride 120 bytes
    # a stride of a dim of length 1 is never stepped
    assert _layout.rows_16b_aligned(buf[:64].view(1, 64).as_strided((1, 64), (3, 1)))
    assert _layout.rows_16b_aligned(x, x[1:])  # 1 x 8 x 64 bf16 = 1024 bytes in: still aligned
    f = torch.zeros(3, 8, dtype=torch.float32)
    assert _layout.rows_16b_aligned(f) and not _layout.rows_16b_aligned(f[:, :6])
