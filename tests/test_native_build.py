"""First-use build of the native libraries (spt_tpu/utils/native.py)."""

import concurrent.futures
import os
import shutil

import pytest

from spt_tpu.utils import native


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    """A copy of native/ so builds never touch the checkout's build dir."""
    src = tmp_path / "native"
    src.mkdir()
    for name, (cpp, _) in native.LIBRARIES.items():
        shutil.copy(os.path.join(native.NATIVE_DIR, cpp), src / cpp)
    monkeypatch.setattr(native, "NATIVE_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(src / "build"))
    monkeypatch.setattr(native, "_loaded", {})
    return src


def test_load_builds_at_first_use(sandbox):
    assert not (sandbox / "build").exists()
    lib = native.load("bvh_builder")
    assert lib is not None and hasattr(lib, "spt_build_bvh")
    built = sorted(os.listdir(sandbox / "build"))
    assert built == ["libbvh_builder.so"]  # no temporary file left behind


def test_stale_library_is_rebuilt(sandbox):
    path = native.build("display")
    old = os.path.getmtime(path) - 100
    os.utime(path, (old, old))
    assert native._stale("display")
    assert native.load("display") is not None
    assert not native._stale("display")


def test_no_compiler_falls_back(sandbox, monkeypatch):
    monkeypatch.setenv("CXX", str(sandbox / "no-such-compiler"))
    assert native.load("bvh_builder") is None
    assert not (sandbox / "build" / "libbvh_builder.so").exists()
    assert os.listdir(sandbox / "build") == []


def test_concurrent_builds_leave_one_valid_library(sandbox):
    """Builders racing (as test workers do) each rename a complete file
    into place; the survivor loads."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        paths = list(pool.map(lambda _: native.build("bvh_builder"),
                              range(6), timeout=300))
    assert len(set(paths)) == 1
    assert os.listdir(sandbox / "build") == ["libbvh_builder.so"]
    assert native.load("bvh_builder") is not None
