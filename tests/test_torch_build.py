"""The port's CUDA build key and launch arguments, on the CPU (no nvcc, no
card).

``ops/cuda_build.library_path`` names a kernel's library by a hash of its
``.cu`` source, every ``csrc/*.cuh`` header and the nvcc flags, so that an
edited shared header (``relpos_scores.cuh``, included by both kernels)
rebuilds both.  The tests point ``CSRC`` at a temporary directory holding
one ``.cu`` and one ``.cuh``.
"""

import os

import pytest
import torch

from k2transducerasr_tpu_torch.ops import attention_cuda as TC
from k2transducerasr_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "kern.cu").write_bytes(b'#include "tile.cuh"\nextern "C" int f() { return 0; }\n')
    (tmp_path / "tile.cuh").write_bytes(b"#pragma once\nconstexpr int kTile = 64;\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    return tmp_path


def test_library_path_is_stable_when_nothing_changes(csrc):
    first = cuda_build.library_path("kern")
    assert cuda_build.library_path("kern") == first
    assert os.path.dirname(first) == cuda_build.BUILD_DIR
    assert os.path.basename(first).startswith("libkern_") and first.endswith(".so")


@pytest.mark.parametrize(
    "edit",
    [
        pytest.param(lambda d: (d / "tile.cuh").write_bytes(b"#pragma once\nconstexpr int kTile = 32;\n"),
                     id="header-edited"),
        pytest.param(lambda d: (d / "tile.cuh").write_bytes((d / "tile.cuh").read_bytes() + b"\n"),
                     id="header-whitespace"),
        pytest.param(lambda d: (d / "other.cuh").write_bytes(b"#pragma once\n"), id="header-added"),
        pytest.param(lambda d: (d / "tile.cuh").rename(d / "tile2.cuh"), id="header-renamed"),
        pytest.param(lambda d: (d / "tile.cuh").unlink(), id="header-removed"),
        pytest.param(lambda d: (d / "kern.cu").write_bytes(b"// edited\n"), id="source-edited"),
    ],
)
def test_library_path_follows_source_and_headers(csrc, edit):
    before = cuda_build.library_path("kern")
    edit(csrc)
    assert cuda_build.library_path("kern") != before


def test_library_path_ignores_files_that_are_not_headers(csrc):
    before = cuda_build.library_path("kern")
    (csrc / "notes.txt").write_bytes(b"not a header\n")
    (csrc / "other.cu").write_bytes(b"// another kernel's source\n")
    assert cuda_build.library_path("kern") == before


def test_library_path_source_argument_overrides_only_the_source(csrc):
    source = (csrc / "kern.cu").read_bytes()
    assert cuda_build.library_path("kern", source) == cuda_build.library_path("kern")
    with_header = cuda_build.library_path("kern", source)
    (csrc / "tile.cuh").write_bytes(b"#pragma once\n")
    assert cuda_build.library_path("kern", source) != with_header


@pytest.mark.parametrize("name", ["relpos_attn_probs", "relpos_attn_ctx"])
def test_kernels_share_the_score_tile_header(name):
    """Both kernels include the shared tile, whose bf16 body runs mma.sync fed
    by cp.async, and keep a float32 body beside it."""
    with open(cuda_build.source_path(name)) as f:
        source = f.read()
    with open(os.path.join(cuda_build.CSRC, "relpos_scores.cuh")) as f:
        header = f.read()
    assert '#include "relpos_scores.cuh"' in source
    assert "rp::masked_scores<" in source
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in header
    assert "cp.async.cg.shared.global" in header and "ldmatrix" in header
    assert "namespace cuda_core" in source  # the float32 body


@pytest.mark.parametrize(
    "dtype,want", [(torch.bfloat16, (512, 512)), (torch.float32, (512, 512))], ids=["bf16", "f32"]
)
def test_probs_max_widths(dtype, want):
    """Both bodies take q and pos heads up to MAX_HEAD: past 64 they sum
    their scores over 64-wide chunks."""
    assert TC._probs_max_widths(dtype) == want == (TC.MAX_HEAD, TC.MAX_HEAD)


def test_probs_rows_only_for_float32():
    """bf16 inputs pass rows = 0; float32 passes its query rows per block,
    8 or T when shorter, whatever S and pd: both bodies take any S."""
    assert TC._probs_rows(torch.bfloat16, 32) == 0
    assert TC._probs_rows(torch.bfloat16, 1532) == 0
    assert TC._probs_rows(torch.float32, 1532) == 8
    assert TC._probs_rows(torch.float32, 5) == 5


def test_lane_ints_passes_none_as_null():
    """An absent lens or kv_start reaches the kernels as a null pointer (no
    tensor is filled for it); a given one becomes [B] int32."""
    assert TC._lane_ints(None, 3, torch.device("cpu")) is None
    assert TC._ptr(None) is None
    lanes = TC._lane_ints(torch.tensor([5, 2, 7]), 3, torch.device("cpu"))
    assert lanes.dtype == torch.int32 and lanes.tolist() == [5, 2, 7]
    assert TC._ptr(lanes) == lanes.data_ptr()
    with pytest.raises(ValueError, match="per-lane"):
        TC._lane_ints(torch.tensor([1, 2]), 3, torch.device("cpu"))
