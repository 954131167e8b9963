"""The port's kernel build (``perceiver_io_tpu_torch/_build.py``), on the CPU
without ``nvcc``: a library's name is a hash of its source, of every shared
header in ``csrc/`` and of the compile and link flags, so an edited header
rebuilds every library instead of loading a stale one."""
import pytest

from perceiver_io_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "csrc" / "shared.cuh").write_text("// one\n")
    return tmp_path / "csrc"


def test_library_name_changes_with_a_header(csrc):
    first = _build._target("k")
    assert first == _build._target("k") and first.parent == _build.BUILD_DIR
    assert first.name.startswith("k-") and first.suffix == ".so"
    (csrc / "shared.cuh").write_text("// two\n")
    second = _build._target("k")
    assert second != first
    (csrc / "added.cuh").write_text("")
    assert _build._target("k") != second
    (csrc / "shared.cuh").write_text("// one\n")
    (csrc / "added.cuh").unlink()
    assert _build._target("k") == first


def test_library_name_changes_with_the_source_and_flags(csrc, monkeypatch):
    first = _build._target("k")
    monkeypatch.setattr(_build, "LINK_FLAGS", _build.LINK_FLAGS + ["-lcuda"])
    linked = _build._target("k")
    assert linked != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._target("k") != linked
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._target("k") not in (first, linked)


def test_build_command_compiles_and_links(csrc, monkeypatch):
    started = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            started.append(cmd)

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakePopen)
    assert _build._start("k") is not None
    cmd = started[0]
    assert cmd[0] == "nvcc" and cmd[-1] == str(csrc / "k.cu")
    for flag in _build.NVCC_FLAGS + _build.LINK_FLAGS:
        assert flag in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    # a built library is loaded as it is, with no nvcc
    target = _build._target("k")
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_bytes(b"")
    assert _build._start("k") is None and len(started) == 1


def test_package_sources_and_headers():
    sources = _build.sources()
    for name in ("flash_attention_fwd", "flash_attention_fwd_wgmma", "flash_attention_fwd_split",
                 "flash_attention_fwd_tf32", "flash_attention_bwd", "flash_attention_bwd_wgmma",
                 "flash_attention_bwd_tf32", "ragged_paged_attention", "ragged_paged_attention_split",
                 "ragged_paged_attention_tc"):
        assert name in sources
    for header, users in (("sm90.cuh", ("flash_attention_fwd_wgmma", "flash_attention_bwd_wgmma")),
                          ("tf32x3.cuh", ("flash_attention_fwd_tf32", "flash_attention_bwd_tf32",
                                          "ragged_paged_attention_tc")),
                          ("vec16.cuh", ("flash_attention_fwd_split", "ragged_paged_attention_split",
                                         "ragged_paged_attention_tc"))):
        assert (_build.CSRC / header).exists()
        for name in users:
            assert f'#include "{header}"' in (_build.CSRC / f"{name}.cu").read_text()
