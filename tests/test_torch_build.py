"""How the kernel libraries are built (``repro_torch.kernels.build``), with
``nvcc`` mocked: a one-source library is one ``nvcc`` to a shared library,
as before; the decode library is one ``nvcc -c`` for each (dtype, head
dim) unit of ``csrc/decode_attention_hd.cu`` and one for its entry points,
all started at once, then one link.  The sources keep one statement of
decode's BUILT rule and of its switches."""
import re
from pathlib import Path
from unittest import mock

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

CSRC = Path(build.__file__).parent / "csrc"


def test_decode_units_cover_every_dtype_and_head_dim():
    units = build.units(da.NAME)
    assert units[0] == (CSRC / "decode_attention.cu", {})
    pairs = {(m["DECODE_DTYPE"], m["DECODE_HD"]) for _, m in units[1:]}
    assert pairs == {(str(c), str(hd)) for c in build.DTYPE_CODES.values()
                     for hd in build.HEAD_DIMS}
    assert {src.name for src, _ in units[1:]} == {"decode_attention_hd.cu"}
    # the entry points' switch over the head dim names the same head dims
    entry = (CSRC / "decode_attention.cu").read_text()
    cases = re.findall(r"case (\d+): return launch_g<T, (\d+)>", entry)
    assert [int(a) for a, b in cases] == list(build.HEAD_DIMS)
    assert all(a == b for a, b in cases)
    for name in build.SIGNATURES:
        if name != da.NAME:
            assert build.units(name) == [(CSRC / f"{name}.cu", {})]


def test_one_statement_of_the_rule_and_the_switches():
    texts = {p.name: p.read_text() for p in CSRC.glob("decode_attention*")}
    where = {n for n, t in texts.items() if "BUILT = " in t}
    assert where == {"decode_attention.cuh"}
    assert sum(t.count("cudaError_t launch_g(int G, const Args& a) {")
               for t in texts.values()) == 1
    assert sum(t.count('extern "C" int decode_attention_built(')
               for t in texts.values()) == 1
    assert "template cudaError_t launch_g<UnitT, DECODE_HD>" in \
        texts["decode_attention_hd.cu"]


def test_decode_compiles_units_at_once_then_links(tmp_path):
    with mock.patch.object(build, "BUILD_DIR", tmp_path), \
            mock.patch.object(build, "nvcc", return_value="nvcc"), \
            mock.patch.object(build.subprocess, "Popen") as popen, \
            mock.patch.object(build.subprocess, "run") as run:
        popen.return_value.communicate.return_value = ("ptxas info\n", None)
        popen.return_value.returncode = 0
        run.return_value.returncode = 0
        run.return_value.stdout = ""
        out, procs = build._start(da.NAME)
        cmds = [c.args[0] for c in popen.call_args_list]
        assert len(cmds) == len(procs) == 1 + 2 * len(build.HEAD_DIMS)
        flags = [f if f != "-shared" else "-c" for f in build.NVCC_FLAGS]
        objs = []
        for cmd, (src, macros) in zip(cmds, build.units(da.NAME)):
            assert cmd[:1 + len(flags)] == ["nvcc", *flags]
            assert cmd[-1] == str(src)
            assert [a for a in cmd if a.startswith("-D")] == [
                f"-D{k}={v}" for k, v in macros.items()]
            objs.append(cmd[cmd.index("-o") + 1])
        assert len(set(objs)) == len(objs)
        assert all(o.endswith(".o") for o in objs)

        def link(cmd, **kw):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"so")
            return run.return_value
        run.side_effect = link
        log = build._finish(da.NAME, out, procs)
        (cmd,), _ = run.call_args
        assert cmd[:4] == ["nvcc", *build.NVCC_FLAGS[:2], "-shared"]
        assert cmd[-len(objs):] == objs
        assert out.read_bytes() == b"so"
        assert log.count("ptxas info") == len(objs)


def test_one_source_libraries_build_as_before(tmp_path):
    with mock.patch.object(build, "BUILD_DIR", tmp_path), \
            mock.patch.object(build, "nvcc", return_value="nvcc"), \
            mock.patch.object(build.subprocess, "Popen") as popen:
        out, procs = build._start("flash_attention_bwd")
        (cmd,), _ = popen.call_args
        assert len(procs) == 1
        assert cmd == ["nvcc", *build.NVCC_FLAGS, "-o", str(procs[0][1]),
                       str(CSRC / "flash_attention_bwd.cu")]
        assert procs[0][1].suffix == ".tmp"
        assert procs[0][1].parent == out.parent


def test_a_failed_unit_fails_the_library(tmp_path):
    with mock.patch.object(build, "BUILD_DIR", tmp_path), \
            mock.patch.object(build, "nvcc", return_value="nvcc"), \
            mock.patch.object(build.subprocess, "Popen") as popen, \
            mock.patch.object(build.subprocess, "run") as run:
        popen.return_value.communicate.return_value = ("error: x\n", None)
        popen.return_value.returncode = 1
        out, procs = build._start(da.NAME)
        with pytest.raises(RuntimeError, match="decode_attention_hd.cu"):
            build._finish(da.NAME, out, procs)
        run.assert_not_called()
        assert not out.exists()


def test_library_path_follows_every_unit(tmp_path):
    base = build.library_path(da.NAME)
    with mock.patch.dict(build.UNITS, {da.NAME: build.UNITS[da.NAME][:-1]}):
        assert build.library_path(da.NAME) != base
    assert build.library_path(da.NAME) == base



def test_build_all_starts_every_unit_and_times_each_library(tmp_path):
    started = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.cmd = cmd
            started.append(cmd[-1])

        def communicate(self):
            Path(self.cmd[self.cmd.index("-o") + 1]).write_bytes(b"x")
            return "ptxas info\n", None

    def link(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"so")
        return mock.Mock(returncode=0, stdout="")

    with mock.patch.object(build, "BUILD_DIR", tmp_path), \
            mock.patch.object(build, "nvcc", return_value="nvcc"), \
            mock.patch.object(build.subprocess, "Popen", Proc), \
            mock.patch.object(build.subprocess, "run", side_effect=link), \
            mock.patch.object(build, "_open", return_value="lib"), \
            mock.patch.dict(build._loaded, clear=True), \
            mock.patch.dict(build.build_seconds, clear=True):
        logs = build.build_all()
        assert sorted(logs) == sorted(build.SIGNATURES)
        assert sorted(build.build_seconds) == sorted(build.SIGNATURES)
        assert all(build.library_path(n).exists() for n in build.SIGNATURES)
        assert build._loaded == {n: "lib" for n in build.SIGNATURES}
    assert sorted(started) == sorted(
        str(src) for n in build.SIGNATURES for src, _ in build.units(n))
