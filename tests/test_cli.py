"""End-to-end smoke tests for the two process-level surfaces
(SURVEY.md §5 config/CLI row): the `run` CLI and the `serve` loop.
Both are driven as real subprocesses — argument parsing, config
resolution, JSON output contract, and artifact writing included."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_run_cli_closed_loop(tmp_path):
    log = tmp_path / "run.jsonl"
    ckpt = tmp_path / "run.ckpt"
    out = subprocess.run(
        [sys.executable, "-m", "pyhybridcontrol_tpu.run",
         "--config", "double_integrator", "--steps", "3", "--batch", "1",
         "--solver", "enumerate", "--cpu",
         "--log", str(log), "--checkpoint", str(ckpt)],
        capture_output=True, text=True, env=_env(), timeout=570)
    assert out.returncode == 0, out.stderr[-2000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["config"] == "double_integrator"
    assert metrics["steps"] == 3
    assert metrics["found_frac"] == 1.0
    assert np.isfinite(metrics["total_cost"])
    # artifacts written and loadable
    assert log.exists() and log.stat().st_size > 0
    from pyhybridcontrol_tpu.io.checkpoint import load_checkpoint

    leaves, step, meta = load_checkpoint(str(ckpt))
    assert step == 3 and meta["config"] == "double_integrator"
    assert len(leaves) > 0 and all(
        np.all(np.isfinite(np.asarray(l, float))) for l in leaves)


def test_run_cli_unknown_config_errors():
    out = subprocess.run(
        [sys.executable, "-m", "pyhybridcontrol_tpu.run",
         "--config", "definitely_not_a_config", "--cpu"],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert out.returncode != 0
    assert "definitely_not_a_config" in (out.stderr + out.stdout)


def test_serve_loop_requests():
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyhybridcontrol_tpu.serve",
         "--config", "double_integrator", "--solver", "enumerate", "--cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env())
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["nx"] == 2

        proc.stdin.write('{"cmd": "ping"}\n')
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["pong"]

        proc.stdin.write(json.dumps({"x": [1.0, -0.5]}) + "\n")
        proc.stdin.flush()
        resp = json.loads(proc.stdout.readline())
        assert resp["found"] and len(resp["u"]) == 1
        assert np.isfinite(resp["obj"]) and resp["ms"] > 0

        # batched request: 2-D x → one device program, list-valued reply
        proc.stdin.write(json.dumps(
            {"x": [[1.0, -0.5], [0.2, 0.7], [-1.0, 0.0]]}) + "\n")
        proc.stdin.flush()
        bresp = json.loads(proc.stdout.readline())
        assert bresp["batch"] == 3
        assert len(bresp["u"]) == 3 and len(bresp["obj"]) == 3
        assert all(bresp["found"])
        # single u of the same state must agree with the batched one
        assert abs(bresp["obj"][0] - resp["obj"]) < 1e-3 * (
            1 + abs(resp["obj"]))

        # malformed request must not kill the server
        proc.stdin.write("this is not json\n")
        proc.stdin.flush()
        assert "error" in json.loads(proc.stdout.readline())
        # wrong state dimension: error response, still serving
        proc.stdin.write(json.dumps({"x": [1.0, 2.0, 3.0]}) + "\n")
        proc.stdin.flush()
        assert "error" in json.loads(proc.stdout.readline())
        proc.stdin.write(json.dumps({"x": [0.0, 0.0]}) + "\n")
        proc.stdin.flush()
        assert json.loads(proc.stdout.readline())["found"]

        proc.stdin.write('{"cmd": "quit"}\n')
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class _TcpClient:
    """Line-delimited-JSON test client for the serve --tcp front."""

    def __init__(self, port):
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=60)
        self.rfile = self.sock.makefile("r")

    def send(self, obj):
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def recv(self):
        return json.loads(self.rfile.readline())

    def close(self):
        self.sock.close()


def test_serve_tcp_coalescing():
    """The TCP front must serve concurrent clients and coalesce
    simultaneously-arriving single-state requests into ONE
    feedback_batch device program (SURVEY.md §5 serving surface)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyhybridcontrol_tpu.serve",
         "--config", "double_integrator", "--solver", "enumerate",
         "--cpu", "--tcp", "0", "--coalesce-window", "500"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())
    clients = []
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["ready"] and ready["tcp_port"] > 0
        port = ready["tcp_port"]

        clients = [_TcpClient(port) for _ in range(3)]
        c0, c1, c2 = clients
        c0.send({"cmd": "ping"})
        assert c0.recv()["pong"]

        # reference solve (uncoalesced): a lone request
        c0.send({"x": [1.0, -0.5], "id": "ref"})
        ref = c0.recv()
        assert ref["id"] == "ref" and ref["found"]

        # three clients fire within the 500 ms window → one batch
        states = {0: [1.0, -0.5], 1: [0.2, 0.7], 2: [-1.0, 0.0]}
        for i, c in enumerate(clients):
            c.send({"x": states[i], "id": i})
        resps = [c.recv() for c in clients]
        for i, r in enumerate(resps):
            assert r["id"] == i and r["found"], r
            assert np.isfinite(r["obj"])
        # coalesced across clients, and client 0's obj matches its
        # uncoalesced solve of the same state
        assert any(r.get("coalesced", 1) >= 2 for r in resps)
        assert abs(resps[0]["obj"] - ref["obj"]) < 1e-3 * (
            1 + abs(ref["obj"]))

        # a client-batched (2-D x) request passes through unchanged
        c1.send({"x": [[0.1, 0.1], [0.5, -0.5]], "id": "b"})
        br = c1.recv()
        assert br["id"] == "b" and br["batch"] == 2 and all(br["found"])

        # bad request on one connection: error reply, server survives
        c2.send({"x": [1.0, 2.0, 3.0], "id": "bad"})
        er = c2.recv()
        assert "error" in er and er["id"] == "bad"
        c2.send({"x": [0.0, 0.0]})
        assert c2.recv()["found"]

        c0.send({"cmd": "stats"})
        st = c0.recv()
        assert st["connections"] == 3
        assert st["max_coalesce"] >= 2 and st["coalesced_batches"] >= 1
        assert st["errors"] >= 1

        # client disconnect must not stop the server
        c2.send({"cmd": "quit"})
        c2.close()
        c0.send({"cmd": "ping"})
        assert c0.recv()["pong"]

        c0.send({"cmd": "shutdown"})
        assert c0.recv()["bye"]
        assert proc.wait(timeout=60) == 0
    finally:
        for c in clients:
            try:
                c.close()
            except OSError:
                pass
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_run_cli_chunked_checkpoint_and_resume(tmp_path):
    ckpt = tmp_path / "study.ckpt"
    base = [sys.executable, "-m", "pyhybridcontrol_tpu.run",
            "--config", "double_integrator", "--batch", "1",
            "--solver", "enumerate", "--cpu"]
    # reference: plain 6-step study
    plain = subprocess.run(base + ["--steps", "6"],
                           capture_output=True, text=True, env=_env(),
                           timeout=570)
    assert plain.returncode == 0, plain.stderr[-2000:]
    ref = json.loads(plain.stdout.strip().splitlines()[-1])

    # chunked: same study in 3 chunks of 2, snapshotting between chunks
    chunked = subprocess.run(
        base + ["--steps", "6", "--checkpoint", str(ckpt),
                "--checkpoint-every", "2"],
        capture_output=True, text=True, env=_env(), timeout=570)
    assert chunked.returncode == 0, chunked.stderr[-2000:]
    got = json.loads(chunked.stdout.strip().splitlines()[-1])
    assert got["resumed_from"] == 0 and got["steps"] == 6
    np.testing.assert_allclose(got["total_cost"], ref["total_cost"],
                               rtol=1e-4)

    # resume: extend the SAME study to 8 steps → only 2 more run
    resumed = subprocess.run(
        base + ["--steps", "8", "--checkpoint", str(ckpt),
                "--checkpoint-every", "2", "--resume"],
        capture_output=True, text=True, env=_env(), timeout=570)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    got2 = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert got2["resumed_from"] == 6 and got2["steps"] == 2

    # resuming a finished study is a no-op, not a crash
    again = subprocess.run(
        base + ["--steps", "8", "--checkpoint", str(ckpt),
                "--checkpoint-every", "2", "--resume"],
        capture_output=True, text=True, env=_env(), timeout=570)
    assert again.returncode == 0
    assert json.loads(again.stdout.strip().splitlines()[-1])["steps"] == 0


def test_bench_crash_isolation(tmp_path):
    """A deliberately-broken bench section must still yield rc=0, the
    primary JSON line, and the error recorded in details — the round-2
    driver artifact was lost because ONE section crashed at the end
    (VERDICT r2 item 2). --inject-error is the testing hook for this."""
    env = _env()
    env["PHC_BENCH_DETAILS_DIR"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, os.path.join(_repo, "bench.py"), "--cpu",
         "--budget", "30", "--inject-error", "config1_double_integrator"],
        capture_output=True, text=True, env=env, timeout=570)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["unit"] == "solves/s" and line["value"] > 0
    d = json.load(open(tmp_path / "BENCH_DETAILS.json"))
    assert "injected test error" in d["config1_double_integrator"]["error"]
    assert d["primary_qp_solves_per_s"] > 0


def test_serve_tcp_deadlines():
    """Per-request deadlines (round 3): a request whose deadline has
    already passed when the solver dequeues it is SHED with a
    deadline_exceeded error instead of solved, and a queued deadline
    pulls the coalescing window closed early (an urgent request must
    not wait out a long hold window)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyhybridcontrol_tpu.serve",
         "--config", "double_integrator", "--solver", "enumerate",
         "--cpu", "--tcp", "0", "--coalesce-window", "5000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env())
    c = None
    try:
        ready = json.loads(proc.stdout.readline())
        port = ready["tcp_port"]
        c = _TcpClient(port)

        # deadline_ms=0: always already expired at dequeue → shed
        c.send({"x": [1.0, -0.5], "deadline_ms": 0, "id": "late"})
        r = c.recv()
        assert r.get("deadline_exceeded") and r["id"] == "late", r
        assert "queued_ms" in r

        # a generous deadline still solves — and the 5 s coalescing
        # window must close early because of it (reply well before the
        # window would have elapsed)
        t0 = time.time()
        c.send({"x": [1.0, -0.5], "deadline_ms": 2000, "id": "ok"})
        r = c.recv()
        dt = time.time() - t0
        assert r["id"] == "ok" and r["found"], r
        assert dt < 4.0, f"window did not close early ({dt:.1f}s)"

        c.send({"cmd": "stats"})
        st = c.recv()
        assert st["deadline_shed"] == 1
        c.send({"cmd": "shutdown"})
    finally:
        if c is not None:
            c.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
