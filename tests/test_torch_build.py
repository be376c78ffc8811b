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


def test_launches_are_counted_by_kv_rows_where_the_wrapper_passes_them(monkeypatch):
    import torch

    monkeypatch.setattr(build, "LAUNCHES", dict(build.LAUNCHES))
    monkeypatch.setattr(build, "LAUNCHES_BY_KV", {})
    build.count_launch("flash_packed_fwd", torch.bfloat16, kv_rows=2304)
    build.count_launch("flash_packed_fwd", torch.bfloat16, kv_rows=512)
    build.count_launch("flash_packed_fwd", torch.bfloat16, kv_rows=512)
    build.count_launch("flash_packed_bwd_dq", torch.float32, kv_rows=512)
    build.count_launch("layer_norm_fwd", torch.bfloat16)
    assert build.LAUNCHES["flash_packed_fwd_bf16"] == 3 and build.LAUNCHES["flash_packed_bwd_dq"] == 1
    assert build.LAUNCHES_BY_KV == {("flash_packed_fwd_bf16", 2304): 1, ("flash_packed_fwd_bf16", 512): 2,
                                    ("flash_packed_bwd_dq", 512): 1}
    build.reset_launches()
    assert build.LAUNCHES_BY_KV == {} and not any(build.LAUNCHES.values())
