"""The port's own native runtime (`openbts_ttsou_tpu_torch/csrc/runtime/`,
built with g++ into `build/native/`) on the CPU: the transport's `poll()`
wait at descriptors past FD_SETSIZE (1024), its timeout and its retry
after a signal, the handle table's size, where the library is built, and
a wire soak whose every socket lies above descriptor 1024.

No test sleeps in a loop: each wait is one call with its own deadline.
UDP ports 56000–56099 (the soak) and free ports the kernel hands out.
"""

import contextlib
import os
import re
import resource
import shutil
import signal
import socket
import time
from pathlib import Path

import pytest

from openbts_ttsou_tpu_torch.runtime import UdpTransport, native
from openbts_ttsou_tpu_torch.tools import common, daemon_soak

ROOT = Path(__file__).resolve().parents[1]
JAX_LIB = ROOT / "native" / "libtrx_runtime.so"
FD_SETSIZE = 1024


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def lowest_free_fd() -> int:
    fd = os.open(os.devnull, os.O_RDONLY)
    os.close(fd)
    return fd


@contextlib.contextmanager
def descriptors_above(floor: int):
    """Hold /dev/null open on every free descriptor below `floor`, so the
    next descriptor the process opens lies at or above it."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < floor + 8192:
        resource.setrlimit(resource.RLIMIT_NOFILE,
                           (min(floor + 8192, hard), hard))
    held = []
    try:
        while lowest_free_fd() < floor:
            held.append(os.open(os.devnull, os.O_RDONLY))
        yield
    finally:
        for fd in held:
            os.close(fd)


def test_socket_past_fd_setsize_sends_and_receives():
    """A socket at a descriptor ≥ 1100 sends a datagram to itself and
    `udt_recv` with a timeout returns it (select() could not wait on
    it)."""
    port = free_udp_port()
    with descriptors_above(1100):
        fd = lowest_free_fd()
        t = UdpTransport(port, "127.0.0.1", port)
        try:
            assert fd >= 1100 and common.largest_fd() >= 1100
            assert t.send(b"past FD_SETSIZE") == 15
            assert t.recv(64, timeout_ms=2000) == b"past FD_SETSIZE"
        finally:
            t.close()


def test_empty_recv_times_out():
    """An empty `udt_recv(…, 50)` returns 0 (None here) after 50–500 ms."""
    t = UdpTransport(free_udp_port())
    try:
        t0 = time.monotonic()
        assert t.recv(64, timeout_ms=50) is None
        waited = time.monotonic() - t0
    finally:
        t.close()
    assert 0.05 <= waited < 0.5, waited


def test_recv_waits_out_its_timeout_across_a_signal():
    """A signal 50 ms into a 300 ms wait interrupts poll() (EINTR); the
    wait resumes for the time left and returns 0 at the deadline, not an
    error at the signal."""
    fired = []
    old = signal.signal(signal.SIGALRM, lambda *a: fired.append(1))
    t = UdpTransport(free_udp_port())
    lib = native.load_runtime()
    import ctypes

    buf = ctypes.create_string_buffer(64)
    try:
        signal.setitimer(signal.ITIMER_REAL, 0.05)
        t0 = time.monotonic()
        rc = lib.udt_recv(t._h, buf, 64, 300)
        waited = time.monotonic() - t0
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
        t.close()
    assert fired and rc == 0
    assert 0.3 <= waited < 1.5, waited


def test_handle_table_takes_a_1024_carrier_soak(tmp_path):
    """6·1024 + 2 sockets open at once, more than a 1024-carrier soak
    holds in one process (4·1024 + 2, past the JAX package's 4096);
    `HANDLE_TABLE` is the source's `kMax`. The sockets are Unix datagram
    sockets, which take handles from the same table and leave the UDP
    ports to other tests running beside this one."""
    src = (native.SRC_DIR / "udp_transport.cpp").read_text()
    k_max = int(re.search(r"constexpr int kMax = (\d+);", src).group(1))
    assert daemon_soak.HANDLE_TABLE == k_max
    need = 6 * 1024 + 2
    assert need <= k_max
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need + 256:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(need + 256, hard),
                                                    hard))
    lib = native.load_runtime()
    handles = []
    try:
        for i in range(need):
            h = lib.udt_open_unix(str(tmp_path / f"h{i}").encode(), b"")
            assert h >= 0, f"open {len(handles) + 1} of {need} failed"
            handles.append(h)
        assert len(set(handles)) == need
    finally:
        for h in handles:
            lib.udt_close(h)


def test_library_is_the_ports_own_build(tmp_path, monkeypatch):
    """The loaded library is `build/native/libtrx_runtime.so`, built with
    g++ from `csrc/runtime/` only; a build writes into its own directory,
    rebuilds when a source is newer, and never makes or touches the JAX
    package's `native/libtrx_runtime.so` (its mtime, or its absence, is
    the same after; one that a JAX test built meanwhile is a different
    library)."""
    before = JAX_LIB.stat().st_mtime_ns if JAX_LIB.exists() else None
    native.load_runtime()
    maps = Path("/proc/self/maps").read_text()
    assert str(native.LIB_PATH) in maps
    assert native.LIB_PATH == ROOT / "build" / "native" / "libtrx_runtime.so"

    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "lib.so")
    calls = []
    run = native.subprocess.run

    def spy(cmd, **kw):
        calls.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    assert native._stale()
    native._build()
    assert not native._stale()
    (cmd,) = calls
    assert cmd[0] == "g++" and all(str(ROOT / "native") not in a
                                   for a in cmd)
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) \
        == ["lib.so"]
    later = time.time() + 10
    os.utime(src / "runtime.h", (later, later))
    assert native._stale()

    if before is not None:
        assert JAX_LIB.stat().st_mtime_ns == before
    elif JAX_LIB.exists():  # a JAX test's `make` ran in another worker
        assert JAX_LIB.read_bytes() != native.LIB_PATH.read_bytes()


def test_build_failure_raises(tmp_path, monkeypatch):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src)
    (src / "sample_ring.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build()
    assert list((tmp_path / "build").iterdir()) == []


def test_soak_runs_clean_above_fd_setsize():
    """A 2-carrier soak (13-frame blocks, inside the daemon's initial
    clock lead of 20, so 1 warm-up block suffices) with every socket
    above descriptor 1024: nothing stale or late, every uplink datagram
    of the timed window arrives."""
    args = daemon_soak.parse_args([
        "--device", "cpu", "--carriers", "2", "--warmup", "1",
        "--blocks", "1", "--block-frames", "13", "--base-port", "56000",
        "--timeout", "120"])
    with descriptors_above(1100):
        first = lowest_free_fd()
        rec = daemon_soak.run(args)
    assert first >= 1100 and rec["largest_fd"] > FD_SETSIZE
    assert rec["stale_dumped"] == 0 and rec["underruns"] == 0
    assert rec["uplink_lost_timed"] == 0
    assert rec["uplink_timed"] == rec["expected_uplink_timed"] == 13 * 2 * 7
