"""Resident worker mode: `dashing2-tpu serve` + transparent client.

A fresh CLI process pays its one-time XLA compiles (or persistent-cache
loads) and device start-up. A resident worker keeps the jitted
executables (and the loaded device runtime) alive across jobs:

    dashing2-tpu serve --socket /tmp/d2.sock &
    DASHING2_TPU_DAEMON=/tmp/d2.sock dashing2-tpu sketch ... # job 1: cold
    DASHING2_TPU_DAEMON=/tmp/d2.sock dashing2-tpu sketch ... # job 2: warm

Protocol (unix stream socket, same-user 0600):
  client -> server: 4-byte length + JSON {op, argv, cwd, env}; the
  client's stdin/stdout/stderr file descriptors ride the SAME sendmsg as
  SCM_RIGHTS ancillary data, and the server dup2()s them over its own
  0/1/2 for the request — so `--cmpout /dev/stdout`, progress logging,
  and shell redirection behave exactly as in a direct invocation.
  server -> client: 4-byte signed return code when the job finishes.

Jobs run sequentially (one accelerator; jit caches are per-process).
`env` carries the client's DASHING2_TPU_* / D2_* knobs and is restored
after each request. The worker is same-host, same-user infrastructure
(like the reference's long-running library use), not a network service.

There is no equivalent in the reference (a C++ binary pays no compile
wall); this replaces its "cheap process startup" property.
"""

from __future__ import annotations

import array
import json
import os
import socket
import struct
import sys
import traceback
from typing import List, Optional, Sequence

_ENV_PREFIXES = ("DASHING2_TPU_", "D2_")
_MAXFDS = 3


def _client_env() -> dict:
    # DASHING2_TPU_DAEMON itself must never reach the worker: the worker
    # dispatching back to its own socket would deadlock
    return {k: v for k, v in os.environ.items()
            if k.startswith(_ENV_PREFIXES) and k != "DASHING2_TPU_DAEMON"}


def _send_request(sock: socket.socket, payload: dict,
                  fds: Optional[List[int]] = None) -> None:
    msg = json.dumps(payload).encode()
    header = struct.pack("!I", len(msg))
    if fds:
        sock.sendmsg([header + msg],
                     [(socket.SOL_SOCKET, socket.SCM_RIGHTS,
                       array.array("i", fds))])
    else:
        sock.sendall(header + msg)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_request(conn: socket.socket):
    """(payload dict, [fds]) — fds arrive with the first chunk."""
    fds: List[int] = []
    msg, anc, _flags, _addr = conn.recvmsg(
        4, socket.CMSG_SPACE(_MAXFDS * 4))
    if not msg:
        raise ConnectionError("peer closed")
    for level, ctype, data in anc:
        if level == socket.SOL_SOCKET and ctype == socket.SCM_RIGHTS:
            a = array.array("i")
            a.frombytes(data[:len(data) - len(data) % 4])
            fds.extend(a)
    while len(msg) < 4:
        msg += _recv_exact(conn, 4 - len(msg))
    (ln,) = struct.unpack("!I", msg[:4])
    body = _recv_exact(conn, ln)
    return json.loads(body), fds


class _RequestContext:
    """Swap the process's cwd, stdio fds, and DASHING2_TPU_* env for the
    duration of one request, restoring everything afterwards."""

    def __init__(self, payload: dict, fds: List[int]):
        self.payload = payload
        self.fds = fds
        self.saved_fds = []
        self.saved_cwd = None
        self.saved_env = {}

    def __enter__(self):
        sys.stdout.flush()
        sys.stderr.flush()
        for i, fd in enumerate(self.fds[:3]):
            self.saved_fds.append(os.dup(i))
            os.dup2(fd, i)
        cwd = self.payload.get("cwd")
        if cwd:
            self.saved_cwd = os.getcwd()
            try:
                os.chdir(cwd)
            except OSError:
                self.saved_cwd = None
        env = self.payload.get("env") or {}
        for k in list(os.environ):
            if k.startswith(_ENV_PREFIXES) and k not in env \
                    and k != "DASHING2_TPU_RESIDENT":
                self.saved_env[k] = os.environ.pop(k)
        for k, v in env.items():
            if k.startswith(_ENV_PREFIXES) and k not in (
                    "DASHING2_TPU_DAEMON", "DASHING2_TPU_RESIDENT"):
                self.saved_env.setdefault(k, os.environ.get(k))
                os.environ[k] = v
        return self

    def __exit__(self, *exc):
        sys.stdout.flush()
        sys.stderr.flush()
        for i, fd in enumerate(self.saved_fds):
            os.dup2(fd, i)
            os.close(fd)
        for fd in self.fds:
            os.close(fd)
        if self.saved_cwd:
            os.chdir(self.saved_cwd)
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def serve_main(socket_path: str, max_requests: int = 0,
               verbose: bool = False,
               warm: Optional[Sequence[str]] = None) -> int:
    """Run the resident worker until shutdown (or max_requests jobs).

    `warm` entries are CLI invocations (shell-split) run once at startup
    BEFORE the socket starts accepting — typically `cmp --warm-only N
    <job flags>` lines that compile the expected compare programs so the
    first real client job lands on a warm jit cache (the reference
    binary pays no compile wall; this replaces that property)."""
    import shlex
    from .cli import main as cli_main
    os.environ.pop("DASHING2_TPU_DAEMON", None)   # no self-dispatch
    # resident marker: engine routing picks compile-heavier/faster-run
    # variants (e.g. the 'rot' OPH engine) since compiles amortize
    # across jobs here (sketch/core._auto_device_engine)
    os.environ["DASHING2_TPU_RESIDENT"] = "1"
    for spec in warm or ():
        argv = shlex.split(spec)
        if verbose:
            print(f"# dashing2-tpu serve: warming `{spec}`",
                  file=sys.stderr, flush=True)
        try:
            cli_main(argv)
        except SystemExit:
            pass
        except BaseException:
            traceback.print_exc()
    try:
        os.unlink(socket_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(socket_path)
    os.chmod(socket_path, 0o600)
    srv.listen(8)
    if verbose:
        print(f"# dashing2-tpu serve: listening on {socket_path} "
              f"(pid {os.getpid()})", file=sys.stderr, flush=True)
    served = 0
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    payload, fds = _recv_request(conn)
                except (ConnectionError, ValueError, json.JSONDecodeError):
                    continue
                op = payload.get("op", "run")
                if op == "ping":
                    for fd in fds:
                        os.close(fd)
                    conn.sendall(struct.pack("!i", 0))
                    continue
                if op == "shutdown":
                    for fd in fds:
                        os.close(fd)
                    conn.sendall(struct.pack("!i", 0))
                    return 0
                rc = 1
                with _RequestContext(payload, fds):
                    try:
                        rc = int(cli_main(payload.get("argv") or []) or 0)
                    except SystemExit as e:
                        rc = int(e.code) if isinstance(e.code, int) else 1
                    except BaseException:
                        traceback.print_exc()
                        rc = 1
                try:
                    conn.sendall(struct.pack("!i", rc))
                except OSError:
                    pass
                served += 1
                if max_requests and served >= max_requests:
                    return 0
    finally:
        srv.close()
        try:
            os.unlink(socket_path)
        except OSError:
            pass


def client_run(socket_path: str, argv: Sequence[str],
               op: str = "run") -> int:
    """Dispatch one CLI invocation to a resident worker; returns its rc.
    Raises OSError when the worker is unreachable (callers fall back to
    a local run)."""
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(socket_path)
    with sock:
        payload = {"op": op, "argv": list(argv), "cwd": os.getcwd(),
                   "env": _client_env()}
        fds = []
        for stream in (sys.stdin, sys.stdout, sys.stderr):
            try:
                fds.append(stream.fileno())
            except (OSError, ValueError, AttributeError):
                fds.append(os.open(os.devnull, os.O_RDWR))
        sys.stdout.flush()
        sys.stderr.flush()
        _send_request(sock, payload, fds)
        (rc,) = struct.unpack("!i", _recv_exact(sock, 4))
    return rc


def maybe_dispatch_to_daemon(argv: List[str]) -> Optional[int]:
    """When DASHING2_TPU_DAEMON names a live worker socket, run the job
    there and return its rc; None means 'run locally' (no daemon
    configured, or it is unreachable)."""
    path = os.environ.get("DASHING2_TPU_DAEMON")
    if not path or (argv and argv[0] == "serve"):
        return None
    try:
        return client_run(path, argv)
    except OSError as e:
        print(f"# dashing2-tpu: daemon at {path} unreachable ({e}); "
              f"running locally", file=sys.stderr)
        return None
