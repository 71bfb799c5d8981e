"""Kernel builds are serialized: threads that reach an unbuilt kernel at
once start one nvcc per library and load it once (`kernels/_build.py`).

nvcc and the library loader are replaced by fakes, so this runs on the
CPU: the fake compiler sleeps before it writes its output, which leaves
every other thread time to race into the build if the lock were missing.
"""

import threading
import time

import pytest

from repro_torch.kernels import _build


class _FakeProc:
    def __init__(self, cmd, log):
        self.cmd = cmd
        self.returncode = 0
        log.append(cmd)

    def communicate(self):
        time.sleep(0.05)
        out = self.cmd[self.cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"fake library")
        return "ptxas info    : Used 32 registers", None


class _FakeLib:
    def __init__(self, path, log):
        log.append(path)
        self.kernel_error_string = lambda code: b"no error"

    def __getattr__(self, symbol):
        fn = lambda *args: 0                         # noqa: E731
        setattr(self, symbol, fn)
        return fn


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """An empty build directory, a fake nvcc and a fake loader; yields the
    lists of compiles and loads they saw."""
    compiles, loads = [], []
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_FUNCS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "/fake/nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen",
                        lambda cmd, **kw: _FakeProc(cmd, compiles))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: _FakeLib(path, loads))
    return compiles, loads


def _from_threads(n, target):
    errors = []

    def run(i):
        try:
            target(i)
        except Exception as e:                       # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors


@pytest.mark.parametrize("name,symbols", [
    ("topk", ("blocked_topk",)),
    ("bsr_predict", ("bsr_predict_f32", "bsr_gather_pq_int8"))])
def test_eight_threads_compile_and_load_once(fake_toolchain, name, symbols):
    compiles, loads = fake_toolchain
    barrier = threading.Barrier(8)
    fns = [None] * 8

    def call(i):
        barrier.wait()
        fns[i] = _build.function(name, symbols[i % len(symbols)],
                                 [_build.ctypes.c_int])

    _from_threads(8, call)
    assert len(compiles) == 1 and compiles[0][-1].endswith(f"{name}.cu")
    assert len(loads) == 1
    assert loads[0] == str(_build.library_path(name))
    assert _build.library_path(name).exists()
    for i, fn in enumerate(fns):
        assert fn is _build.function(name, symbols[i % len(symbols)], [])
    assert not list(_build.BUILD_DIR.glob("*.tmp"))


def test_temporary_names_are_per_thread(fake_toolchain):
    """Two threads building different kernels write different temporary
    files, each named by process and thread."""
    compiles, _ = fake_toolchain
    names = ("topk", "hinge")
    _from_threads(2, lambda i: _build.build((names[i],)))
    tmps = [c[c.index("-o") + 1] for c in compiles]
    assert len(tmps) == 2 and len(set(tmps)) == 2
    assert all(str(threading.get_ident()) not in t for t in tmps)
    assert all(_build.library_path(n).exists() for n in names)
    assert sorted(_build.BUILD_LOGS) == sorted(names)
