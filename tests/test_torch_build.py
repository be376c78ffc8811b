"""``ops/build.py``'s cache of built kernel libraries, on the CPU with a
stand-in for ``nvcc``: a source is compiled once, and a later
``build_all`` (another process's, with an empty ``BUILD_LOGS``) finds the
library and reads its build log back, so the ``ptxas`` report that
``chip_smoke.py`` checks for spills never comes up empty."""

import os
import stat
import sys

from perceiver_io_tpu_torch.ops import build

FAKE_NVCC = f"""#!{sys.executable}
import sys
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "w").write("library")
with open(sys.argv[0] + ".calls", "a") as f:
    f.write(sys.argv[-1] + "\\n")
print("ptxas info    : Compiling entry function 'fake_kernel' for 'sm_90a'")
print("ptxas info    : Used 42 registers")
"""


def test_cached_library_keeps_its_build_log(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    paths = build.build_all(["paged_decode"])
    assert os.path.isfile(paths["paged_decode"])
    first = build.BUILD_LOGS["paged_decode"]
    assert "Used 42 registers" in first
    # a new process: nothing in memory, the library cached on disk
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    assert build.build_all(["paged_decode"]) == paths
    assert build.BUILD_LOGS["paged_decode"] == first
    assert len((tmp_path / "nvcc.calls").read_text().splitlines()) == 1
    # a library without its log (built before logs were kept) is rebuilt
    os.remove(paths["paged_decode"] + ".log")
    monkeypatch.setattr(build, "BUILD_LOGS", {})
    build.build_all(["paged_decode"])
    assert build.BUILD_LOGS["paged_decode"] == first
    assert len((tmp_path / "nvcc.calls").read_text().splitlines()) == 2
