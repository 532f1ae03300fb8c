"""`metamorph_tpu_torch/kernels/_build.py` on the CPU (no nvcc needed): the
library's name is keyed by every CUDA source and every shared header, and
only the `.cu` sources are compiled, each with the header directory on its
include path. nvcc is replaced by a stand-in that writes its outputs."""

import subprocess
from pathlib import Path

import pytest

from metamorph_tpu_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "a.cu").write_text('#include "h.cuh"\n// a\n')
    (d / "b.cu").write_text("// b\n")
    (d / "h.cuh").write_text("// h, first version\n")
    monkeypatch.setattr(_build, "CSRC", d)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return d


def test_the_shipped_tree_has_a_shared_header():
    assert [p.name for p in _build.headers()] == ["sm90.cuh"]
    assert all(p.suffix == ".cu" for p in _build.sources())
    assert "w8_matmul.cu" in [p.name for p in _build.sources()]


@pytest.mark.parametrize("name", sorted(
    p.name for p in _build.CSRC.glob("*.cu*")))
def test_sources_include_no_pytorch_header(name):
    """Every kernel source (kernel F's `w8_matmul.cu` among them) has a
    plain C interface and includes only CUDA's headers and the shared
    ones, which keeps nvcc at seconds."""
    import re

    text = (_build.CSRC / name).read_text()
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', text)
    assert includes
    assert not [i for i in includes
                if i.split("/")[0] in ("torch", "ATen", "c10", "pybind11")]


@pytest.mark.parametrize("change", ["edit_header", "edit_source",
                                    "add_source", "add_header"])
def test_library_name_changes_with_the_tree(csrc, change):
    before = _build.library_path()
    assert _build.library_path() == before
    if change == "edit_header":
        (csrc / "h.cuh").write_text("// h, second version\n")
    elif change == "edit_source":
        (csrc / "b.cu").write_text("// b, second version\n")
    elif change == "add_source":
        (csrc / "c.cu").write_text("// c\n")
    else:
        (csrc / "g.cuh").write_text("// g\n")
    assert _build.library_path() != before


def test_library_name_ignores_other_files(csrc):
    before = _build.library_path()
    (csrc / "notes.txt").write_text("not a source\n")
    assert _build.library_path() == before


def test_only_cu_sources_compile_with_the_header_dir(csrc, monkeypatch):
    calls = []

    def touch_output(cmd):
        calls.append(list(cmd))
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            touch_output(cmd)

        def communicate(self):
            return "", None

    def run(cmd, **kwargs):
        touch_output(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    lib = _build._Library()
    out = lib.build()
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    assert sorted(Path(c[-1]).name for c in compiles) == ["a.cu", "b.cu"]
    for c in compiles:
        assert c[c.index("-I") + 1] == str(csrc)
        assert "arch=compute_90a,code=sm_90a" in c
    assert len(links) == 1
    assert not any(a.endswith((".cu", ".cuh")) for a in links[0])
    assert out == _build.library_path() and out.exists()
    assert not list(out.parent.glob("*.o"))      # objects removed
    calls.clear()
    assert lib.build() == out and calls == []    # an unchanged tree is reused


def test_shared_memory_opt_in_is_per_device():
    """The dynamic shared-memory limit is raised per device, not once per
    process: no CUDA source keeps a `static bool sized`, the one
    cudaFuncSetAttribute is inside sm90.cuh's helper (which reads the
    current device), and every launch with dynamic shared memory has its
    own call of the helper beside it."""
    import re

    text = {p.name: p.read_text() for p in _build.sources() + _build.headers()}
    assert not any("static bool sized" in t for t in text.values())
    sets = {n: t.count("cudaFuncSetAttribute(") for n, t in text.items()}
    assert sets == {**{n: 0 for n in text}, "sm90.cuh": 1}
    helper = text["sm90.cuh"]
    body = helper[helper.index("inline cudaError_t smem_opt_in("):]
    assert body.index("cudaGetDevice(") < body.index("cudaFuncSetAttribute(")
    for name, t in text.items():
        launches = re.findall(r"<<<[^>]*>>>", t)
        # a launch naming dynamic shared memory (a third argument that is
        # not the literal 0)
        shared = [x for x in launches if x.count(",") >= 2
                  and not re.search(r"<<<[^,]*,[^,]*,\s*0\s*,", x)]
        assert all(re.search(r",\s*bytes\s*,", x) for x in shared), name
        assert t.count("smem_opt_in<") == len(shared), name
    assert sum(t.count("smem_opt_in<") for t in text.values()) == 9
