"""The kernel build's library key on the CPU: ``_build.library_path`` names
a library by a hash of its ``.cu`` source, of every ``csrc`` header the
source includes (directly or through another header) and of the flags, so
an edited header rebuilds the libraries that include it and no other."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (src / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n'
                              'int f() { return g(); }\n')
    (src / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n'
                               'static int g() { return h(); }\n')
    (src / "b.cuh").write_text('static int h() { return 1; }\n')
    (src / "other.cuh").write_text('static int u() { return 0; }\n')
    (src / "plain.cu").write_text('int p() { return 0; }\n')
    return src


def test_sources_follow_includes(csrc):
    assert _build.sources("k") == ["k.cu", "a.cuh", "b.cuh"]
    assert _build.sources("plain") == ["plain.cu"]


@pytest.mark.parametrize("edit, moves", [
    ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("other.cuh", False)])
def test_library_path_changes_with_an_included_header(csrc, edit, moves):
    before = _build.library_path("k")
    plain = _build.library_path("plain")
    assert before.parent == _build.BUILD_DIR
    assert before.name.startswith("k-") and before.suffix == ".so"
    (csrc / edit).write_text((csrc / edit).read_text() + "// edited\n")
    assert (_build.library_path("k") != before) == moves
    assert _build.library_path("plain") == plain


def test_flash_sources_share_their_header():
    """Both flash libraries key on the header of Hopper helpers they
    include."""
    for name in ("flash_attention", "flash_attention_bwd"):
        assert _build.sources(name) == [f"{name}.cu", "flash_tc.cuh"]
    assert _build.sources("rmsnorm") == ["rmsnorm.cu"]


def test_scan_backward_keys_on_the_shared_header():
    """The scan's backward builds its wgmma products from the same header,
    so an edit there rebuilds it too; its forward includes none."""
    assert _build.sources("ssm_scan_bwd") == ["ssm_scan_bwd.cu",
                                              "flash_tc.cuh"]
    assert _build.sources("ssm_scan") == ["ssm_scan.cu"]
