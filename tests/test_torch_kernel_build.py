"""The port's kernel builder (`repro_torch/kernels/build.py`): the library a
build loads is named by a hash of the flags, the sources and the headers
they include, so an edited header is never answered with a stale library.
No nvcc is needed: only the path is computed.
"""
from pathlib import Path

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as k2_ops
from repro_torch.kernels.flash_decode import ops as k4_ops
from repro_torch.kernels.ssd_scan import ops as k3_ops


def _files(tmp_path: Path, header: bytes):
    src, hdr = tmp_path / "k.cu", tmp_path / "common.cuh"
    src.write_bytes(b'#include "common.cuh"\n__global__ void k() {}\n')
    hdr.write_bytes(header)
    return (src,), (hdr,)


def test_library_path_changes_with_a_headers_bytes(tmp_path):
    srcs, hdrs = _files(tmp_path, b"#define N 1\n")
    first = build.library_path("k", srcs, hdrs)
    assert build.library_path("k", srcs, hdrs) == first  # same bytes, same path
    hdrs[0].write_bytes(b"#define N 2\n")
    second = build.library_path("k", srcs, hdrs)
    assert second != first
    hdrs[0].write_bytes(b"#define N 1\n")
    assert build.library_path("k", srcs, hdrs) == first
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk-")


def test_library_path_changes_with_source_and_flags(tmp_path, monkeypatch):
    srcs, hdrs = _files(tmp_path, b"#define N 1\n")
    first = build.library_path("k", srcs, hdrs)
    assert build.library_path("k", srcs) != first  # the header is in the hash
    srcs[0].write_bytes(srcs[0].read_bytes() + b"// edit\n")
    assert build.library_path("k", srcs, hdrs) != first
    srcs2, _ = _files(tmp_path, b"#define N 1\n")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k", srcs2, hdrs) != first


def test_attention_kernels_name_their_shared_header():
    """K2, K4 and K3 include hopper.cuh and name it, so an edit to it
    rebuilds each of them."""
    for ops in (k2_ops, k4_ops, k3_ops):
        assert all(p.is_file() for p in (*ops.SOURCES, *ops.HEADERS))
        assert any(p.name == "hopper.cuh" for p in ops.HEADERS)
        for src in ops.SOURCES:
            assert '#include "../../common/csrc/hopper.cuh"' in src.read_text()
