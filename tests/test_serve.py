"""Resident-worker (serve) mode: jobs dispatched over the unix socket
produce byte-identical outputs to direct invocations, stdio fds pass
through, env knobs apply per request, and the worker survives job
errors."""

import os
import random
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from dashing2_tpu.serve import client_run

HERE = os.path.dirname(os.path.abspath(__file__))


def _write_fasta(path, n=5, length=600, seed=0):
    random.seed(seed)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f">s{i}\n")
            f.write("".join(random.choice("ACGT")
                            for _ in range(length)) + "\n")


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    sock = str(d / "d2.sock")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dashing2_tpu.cli", "serve",
         "--socket", sock, "-v"],
        env=env, stderr=subprocess.PIPE)
    for _ in range(300):
        if os.path.exists(sock):
            try:
                client_run(sock, [], op="ping")
                break
            except OSError:
                pass
        time.sleep(0.2)
    else:
        proc.kill()
        raise RuntimeError("worker did not come up")
    yield sock
    try:
        client_run(sock, [], op="shutdown")
        proc.wait(timeout=30)
    except Exception:
        proc.kill()


def test_serve_output_identical_to_direct(worker, tmp_path):
    fa = str(tmp_path / "a.fa")
    _write_fasta(fa, n=6, length=900, seed=3)
    direct = str(tmp_path / "direct.bin")
    viad = str(tmp_path / "daemon.bin")
    args = ["sketch", "-k", "17", "-S", "128", "--parse-by-seq",
            "--binary-output", "--cmpout"]
    from dashing2_tpu.cli import main
    assert main(args + [direct, fa]) == 0
    rc = client_run(worker, args + [viad, fa])
    assert rc == 0
    assert open(direct, "rb").read() == open(viad, "rb").read()
    # warm repeat: same bytes again (exercises executable-cache reuse)
    viad2 = str(tmp_path / "daemon2.bin")
    assert client_run(worker, args + [viad2, fa]) == 0
    assert open(direct, "rb").read() == open(viad2, "rb").read()


def test_serve_stdout_fd_passthrough(worker, tmp_path):
    """--cmpout /dev/stdout in the worker writes to the CLIENT's stdout
    (the request dup2s the client fds over the worker's 0/1/2)."""
    fa = str(tmp_path / "b.fa")
    _write_fasta(fa, n=4, length=700, seed=5)
    outp = str(tmp_path / "cap.txt")
    # run a real subprocess client so fd passing crosses processes
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["DASHING2_TPU_DAEMON"] = worker
    with open(outp, "w") as out:
        r = subprocess.run(
            [sys.executable, "-m", "dashing2_tpu.cli", "cmp",
             "--parse-by-seq", "-k", "17", "-S", "64", fa],
            env=env, stdout=out, stderr=subprocess.PIPE, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    body = open(outp).read()
    assert body.startswith("#Dashing2 Symmetric pairwise Output")
    assert "s0" in body


def test_serve_survives_job_error_and_bad_argv(worker, tmp_path):
    rc = client_run(worker, ["sketch", "--cmpout", "x",
                             str(tmp_path / "missing.fa")])
    assert rc != 0
    # worker still alive and serving
    fa = str(tmp_path / "c.fa")
    _write_fasta(fa, n=3, length=500, seed=9)
    out = str(tmp_path / "ok.phy")
    assert client_run(worker, ["sketch", "--parse-by-seq", "-k", "15",
                               "-S", "64", "--cmpout", out, fa]) == 0
    assert os.path.getsize(out) > 0


def test_serve_env_knobs_apply_per_request(worker, tmp_path):
    """A DASHING2_TPU_* knob sent with one request must not leak into
    the next; outputs stay byte-identical either way (the knobs select
    bit-identical engines by design)."""
    fa = str(tmp_path / "d.fa")
    _write_fasta(fa, n=5, length=800, seed=11)
    outs = []
    for i, knob in enumerate([{}, {"DASHING2_TPU_KERNEL": "swar"}, {}]):
        out = str(tmp_path / f"e{i}.bin")
        saved = {k: os.environ.get(k) for k in knob}
        os.environ.update(knob)
        try:
            rc = client_run(worker, ["sketch", "--parse-by-seq", "-k",
                                     "17", "-S", "128", "--binary-output",
                                     "--cmpout", out, fa])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert rc == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] == outs[2]


def test_warm_only_flag_runs_standalone(capsys):
    """`cmp --warm-only N` compiles the compare program set for an
    announced item count and exits 0 without any input paths."""
    from dashing2_tpu.cli import main
    assert main(["cmp", "--warm-only", "128", "-S", "64"]) == 0


def test_serve_warm_startup(tmp_path):
    """`serve --warm 'cmp --warm-only N ...'` precompiles at startup,
    then serves jobs normally."""
    sock = str(tmp_path / "warm.sock")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dashing2_tpu.cli", "serve",
         "--socket", sock, "-v", "--warm", "cmp --warm-only 128 -S 64"],
        env=env, stderr=subprocess.PIPE)
    try:
        for _ in range(300):
            if os.path.exists(sock):
                try:
                    client_run(sock, [], op="ping")
                    break
                except OSError:
                    pass
            time.sleep(0.2)
        else:
            raise RuntimeError("warmed worker did not come up")
        fa = str(tmp_path / "w.fa")
        _write_fasta(fa, n=4, length=600, seed=21)
        out = str(tmp_path / "w.phy")
        assert client_run(sock, ["sketch", "--parse-by-seq", "-k", "15",
                                 "-S", "64", "--cmpout", out, fa]) == 0
        assert os.path.getsize(out) > 0
    finally:
        try:
            client_run(sock, [], op="shutdown")
            proc.wait(timeout=30)
        except Exception:
            proc.kill()


def test_daemon_fallback_when_unreachable(tmp_path, monkeypatch, capsys):
    """DASHING2_TPU_DAEMON pointing at a dead socket falls back to a
    local run instead of failing."""
    fa = str(tmp_path / "f.fa")
    _write_fasta(fa, n=3, length=500, seed=13)
    out = str(tmp_path / "fb.phy")
    monkeypatch.setenv("DASHING2_TPU_DAEMON", str(tmp_path / "nope.sock"))
    from dashing2_tpu.cli import main
    assert main(["sketch", "--parse-by-seq", "-k", "15", "-S", "64",
                 "--cmpout", out, fa]) == 0
    assert os.path.getsize(out) > 0
