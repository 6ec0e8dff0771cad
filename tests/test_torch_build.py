"""The kernel build's cache key (``deeplearning4j_tpu_torch/ops/_build.py``
``source_digest``): a library is keyed on its ``.cu`` source and every
shared ``csrc/*.cuh`` header, so an edit to either rebuilds it and nothing
else does. Runs on a copy of ``csrc/`` without nvcc."""

import shutil

import pytest

from deeplearning4j_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, dst)
    return dst


def _append(path, text="\n// edited\n"):
    path.write_text(path.read_text() + text)


def test_the_checkout_has_a_shared_header_and_the_flash_sources():
    headers = sorted(p.name for p in _build.SOURCE_DIR.glob("*.cuh"))
    assert "sm90_common.cuh" in headers
    for name in ("flash_fwd", "flash_bwd"):
        assert '#include "sm90_common.cuh"' in (_build.SOURCE_DIR / f"{name}.cu").read_text()


def test_digest_is_stable_and_the_same_for_a_copy(csrc):
    for name in ("flash_fwd", "flash_bwd", "fused_lstm_fwd"):
        assert _build.source_digest(name, csrc) == _build.source_digest(name)
        assert _build.source_digest(name, csrc) == _build.source_digest(name, csrc)
    assert _build.source_digest("flash_fwd", csrc) != _build.source_digest("flash_bwd", csrc)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_editing_the_source_changes_only_its_digest(csrc, name):
    other = "flash_bwd" if name == "flash_fwd" else "flash_fwd"
    before = {n: _build.source_digest(n, csrc) for n in (name, other)}
    _append(csrc / f"{name}.cu")
    assert _build.source_digest(name, csrc) != before[name]
    assert _build.source_digest(other, csrc) == before[other]


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd", "fused_lstm_bwd"])
def test_editing_or_adding_a_header_changes_the_digest(csrc, name):
    before = _build.source_digest(name, csrc)
    _append(csrc / "sm90_common.cuh")
    edited = _build.source_digest(name, csrc)
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.source_digest(name, csrc) not in (before, edited)


def test_renaming_a_header_changes_the_digest(csrc):
    before = _build.source_digest("flash_fwd", csrc)
    (csrc / "sm90_common.cuh").rename(csrc / "sm90_common2.cuh")
    assert _build.source_digest("flash_fwd", csrc) != before


def test_other_files_do_not_change_the_digest(csrc):
    before = {n: _build.source_digest(n, csrc) for n in ("flash_fwd", "flash_bwd")}
    _append(csrc / "fused_lstm_fwd.cu")
    (csrc / "notes.txt").write_text("not a source\n")
    (csrc / "scratch.h").write_text("// not a .cuh\n")
    (csrc.parent / "elsewhere.cuh").write_text("// outside csrc\n")
    assert {n: _build.source_digest(n, csrc) for n in before} == before


def test_the_library_name_carries_the_digest(csrc, monkeypatch, tmp_path):
    # a built library under the current digest is loaded without nvcc; a
    # header edit changes the name build() looks for
    monkeypatch.setattr(_build, "SOURCE_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = tmp_path / "build" / f"libflash_fwd-{_build.source_digest('flash_fwd', csrc)}.so"
    lib.parent.mkdir()
    lib.write_bytes(b"")
    assert _build.build("flash_fwd") == lib
    _append(csrc / "sm90_common.cuh")
    monkeypatch.setattr(_build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("would build")))
    with pytest.raises(RuntimeError, match="would build"):
        _build.build("flash_fwd")
