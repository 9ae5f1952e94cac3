"""The port's kernel build step (``ops/_build.py``) with a stand-in for nvcc.

The stand-in writes its command line into the ``-o`` file and prints a line
naming the source, as ptxas prints its report, so the tests see what
``build_all`` asked for without a CUDA toolkit: results come back in the
order of the sources, a library that is already built is reused with the
compiler output of its build, an edited shared header gives a new library,
and a failed build names its source and leaves no library behind.
"""

import sys

import pytest

from distributed_tensorflow_framework_torch.ops import _build

FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
src = args[-1]
if src.endswith("fail.cu"):
    print("error: " + src)
    sys.exit(2)
out = args[args.index("-o") + 1]
with open(out, "w") as fh:
    fh.write(" ".join(args))
print("ptxas info : " + src)
"""


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    sources = []
    for name in ("a.cu", "b.cu", "fail.cu"):
        src = tmp_path / name
        src.write_text(f"// {name}\n")
        sources.append(src)
    return sources


def test_results_follow_the_sources_and_reuse_keeps_the_log(fake_nvcc):
    a, b, _ = fake_nvcc
    first = _build.build_all([a])[0]
    # b is new, a is reused: the order of the sources holds.
    res = _build.build_all([b, a])
    assert [r.source for r in res] == [b, a]
    assert res[0].seconds > 0.0 and res[1].seconds == 0.0
    assert res[1].library == first.library == _build.library_path(a)
    assert res[1].log == first.log and str(a) in res[1].log


def test_a_failed_build_names_its_source_and_leaves_no_library(fake_nvcc):
    a, _, bad = fake_nvcc
    with pytest.raises(_build.KernelBuildError, match="fail.cu"):
        _build.build_all([a, bad])
    assert not _build.library_path(bad).exists()
    assert not list((_build.BUILD_DIR).glob("libfail*"))
    assert _build.library_path(a).exists()  # the good source still built


def test_an_edited_header_gives_a_new_library(fake_nvcc, tmp_path,
                                               monkeypatch):
    """Every library's name carries the hash of the shared headers, so a
    library built before a header changed is never loaded after it."""
    a, _, _ = fake_nvcc
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    old = _build.build_all([a])[0]
    header.write_text("// two\n")
    new = _build.build_all([a])[0]
    assert new.library != old.library and new.seconds > 0.0
    assert new.library == _build.library_path(a)
