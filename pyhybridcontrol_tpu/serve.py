"""Real-time controller serving loop:

    python -m pyhybridcontrol_tpu.serve --config double_integrator

stdin mode (default): one JSON request per line on stdin, one JSON
response per line on stdout — the minimal production-embedding surface.
The controller itself is a single resident device program, so
per-request latency after warmup is one feedback solve — the measured
number is the config-1 ``ms_per_control_step`` cell of the benchmark
(do not hard-code it here).

TCP mode (``--tcp PORT``; the SURVEY.md §5 serving surface hardened):
a line-delimited-JSON socket front serving many concurrent clients from
ONE resident controller. Single-state requests arriving together —
from the same or different connections — are COALESCED into one padded
``feedback_batch`` device program (pad to the next power of two, so the
number of distinct compiled batch shapes is log-bounded), then the
responses are demultiplexed back per client. ``--coalesce-window MS``
holds the batch open that long after the first request (0 = drain-only:
batch whatever is already queued). Device work stays on one thread —
one process owns the card — so coalescing is what turns
request concurrency into device throughput (config-4 economics:
the pooled batch engine measures ~3.5x the per-instance form).

Request:  {"x": [..nx..], "omega": [[..]] (N,nω) opt, "price": [[..]] opt,
           "u_prev": [..] opt, "id": any opt (echoed back),
           "deadline_ms": f opt (TCP mode: per-request deadline —
           a request still QUEUED past its deadline is shed with
           {"error": "deadline exceeded", "deadline_exceeded": true}
           instead of burning device time on an answer the caller has
           abandoned; a queued deadline also pulls the coalescing
           window closed early — to half the deadline budget, the
           other half reserved for the solve — so urgent requests
           don't wait out, or expire inside, the full hold)}
Response: {"u": [..], "delta": [..], "obj": f, "found": b, "gap": f,
           "ms": f, "coalesced": B (TCP mode, when batched)}
A 2-D "x" ([[..nx..] × B]) solves the whole batch as ONE device
program (``MpcController.feedback_batch``) and returns list-valued
"u"/"delta"/"obj"/"found" — the aggregation path for many plants
behind one controller process.
Send {"cmd": "ping"} for a health check, {"cmd": "stats"} for serving
counters, {"cmd": "quit"} to stop (stdin mode) / close the connection
(TCP mode), {"cmd": "shutdown"} to stop the TCP server.

Per-connection responses are in request order for serial clients;
pipelining clients should pass "id" to correlate (coalescing may
reorder grouped vs ungrouped requests).
"""

from __future__ import annotations

import argparse
import json
import queue
import socket
import sys
import threading
import time


def _build_controller(args):
    import jax
    import jax.numpy as jnp

    from pyhybridcontrol_tpu.configs import get_config
    from pyhybridcontrol_tpu.control.mpc import MpcController

    cfg = get_config(args.config)
    model, ckw = cfg.build()
    ctrl = MpcController(model, cfg.N, solver=args.solver,
                         bnb_spec=cfg.bnb, qp_iters=cfg.bnb.qp_iters, **ckw)
    if cfg.soft_rows:
        ctrl.set_soft_constraints(list(cfg.soft_rows), lin_pen=5.0,
                                  quad_pen=1.0)
    ctrl.build()
    # warmup compile so the first real request is fast
    ctrl.feedback(jnp.zeros(model.info.nx))
    dev = jax.devices()[0]
    ready = {"ready": True, "config": cfg.name, "nx": model.info.nx,
             "nu": model.info.nu, "N": cfg.N, "platform": dev.platform,
             "device_kind": dev.device_kind}
    return ctrl, ready


def _parse_arrays(req):
    import numpy as np

    x = np.asarray(req["x"], np.float32)
    W = (np.asarray(req["omega"], np.float32)
         if req.get("omega") is not None else None)
    Pq = (np.asarray(req["price"], np.float32)
          if req.get("price") is not None else None)
    up = (np.asarray(req["u_prev"], np.float32)
          if req.get("u_prev") is not None else None)
    return x, W, Pq, up


def _solve_one(ctrl, req):
    """Solve a single request dict → response dict (no 'id' echo)."""
    import numpy as np

    x, W, Pq, up = _parse_arrays(req)
    t0 = time.perf_counter()
    if x.ndim == 2:              # client-batched request
        sol = ctrl.feedback_batch(x, omega_forecasts=W, price_seq=Pq,
                                  u_prevs=up)
        ms = 1e3 * (time.perf_counter() - t0)
        return {"u": np.asarray(sol.u).tolist(),
                "delta": np.asarray(sol.delta).tolist(),
                "obj": np.asarray(sol.obj).tolist(),
                "found": np.asarray(sol.found).tolist(),
                "batch": int(x.shape[0]), "ms": round(ms, 3)}
    sol = ctrl.feedback(x, omega_forecast=W, price_seq=Pq, u_prev=up)
    ms = 1e3 * (time.perf_counter() - t0)
    return {"u": np.asarray(sol.u).tolist(),
            "delta": np.asarray(sol.delta).tolist(),
            "obj": float(sol.obj), "found": bool(sol.found),
            "gap": float(getattr(sol, "gap", 0.0)),
            "ms": round(ms, 3)}


def _coalesce_key(req):
    """Group key for cross-client coalescing: requests are stackable
    into one ``feedback_batch`` call iff their x is 1-D, their
    omega/u_prev shapes agree (present-for-all or absent-for-all along
    each channel) and price_seq — shared across the batch by the batch
    API — is identical."""
    import numpy as np

    x, W, Pq, up = _parse_arrays(req)
    if x.ndim != 2 and x.ndim != 1:
        raise ValueError(f"x must be 1-D or 2-D, got ndim={x.ndim}")
    if x.ndim != 1:
        return None              # client-batched: pass through
    price_key = (None if Pq is None
                 else (Pq.shape, Pq.tobytes()))
    return (x.shape, None if W is None else W.shape,
            None if up is None else up.shape, price_key)


def _solve_group(ctrl, reqs):
    """Solve a same-key group of 1-D requests as ONE padded
    feedback_batch program; returns one response dict per request."""
    import numpy as np

    parsed = [_parse_arrays(r) for r in reqs]
    B = len(parsed)
    # pad to the next power of two: log-bounded set of compiled shapes
    Bp = 1
    while Bp < B:
        Bp *= 2
    pad = Bp - B
    xs = np.stack([p[0] for p in parsed] + [parsed[0][0]] * pad)
    Ws = (np.stack([p[1] for p in parsed] + [parsed[0][1]] * pad)
          if parsed[0][1] is not None else None)
    ups = (np.stack([p[3] for p in parsed] + [parsed[0][3]] * pad)
           if parsed[0][3] is not None else None)
    Pq = parsed[0][2]
    t0 = time.perf_counter()
    sol = ctrl.feedback_batch(xs, omega_forecasts=Ws, price_seq=Pq,
                              u_prevs=ups)
    ms = 1e3 * (time.perf_counter() - t0)
    u = np.asarray(sol.u)
    delta = np.asarray(sol.delta)
    obj = np.asarray(sol.obj)
    found = np.asarray(sol.found)
    gap = np.asarray(getattr(sol, "gap", np.zeros(Bp)))
    out = []
    for i in range(B):
        out.append({"u": u[i].tolist(), "delta": delta[i].tolist(),
                    "obj": float(obj[i]), "found": bool(found[i]),
                    "gap": float(np.ravel(gap)[i]) if gap.size else 0.0,
                    "ms": round(ms, 3), "coalesced": B})
    return out


class _TcpServer:
    """Threaded socket front: reader thread per connection → one shared
    request queue → ONE solver thread (the device is a single-program
    resource). Writers take the connection's lock, so solver responses
    and reader-side errors interleave safely."""

    def __init__(self, ctrl, ready, host, port, window_ms, max_batch):
        self.ctrl = ctrl
        self.ready = ready
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.q: queue.Queue = queue.Queue()
        self.stop = threading.Event()
        self.stats_lock = threading.Lock()
        self.stats = {"requests": 0, "errors": 0, "coalesced_batches": 0,
                      "max_coalesce": 1, "connections": 0,
                      "deadline_shed": 0}
        self.srv = socket.create_server((host, port))
        self.port = self.srv.getsockname()[1]

    @staticmethod
    def _send(conn_entry, obj):
        conn, lock = conn_entry
        data = (json.dumps(obj) + "\n").encode()
        try:
            with lock:
                conn.sendall(data)
        except OSError:
            pass                  # client went away; solver keeps going

    def _reader(self, conn):
        entry = (conn, threading.Lock())
        with self.stats_lock:
            self.stats["connections"] += 1
        buf = b""
        try:
            while not self.stop.is_set():
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as e:
                        self._send(entry, {"error": f"bad json: {e}"})
                        continue
                    cmd = req.get("cmd")
                    if cmd == "ping":      # health: no device round-trip
                        self._send(entry, {"pong": True})
                        continue
                    if cmd == "stats":
                        with self.stats_lock:
                            self._send(entry, dict(self.stats))
                        continue
                    if cmd == "quit":
                        return
                    if cmd == "shutdown":
                        self._send(entry, {"bye": True})
                        self.stop.set()
                        self.q.put(None)   # wake the solver thread
                        return
                    self.q.put((entry, req, time.monotonic()))
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _req_pull_close(item):
        """Window pull-close time (monotonic) implied by a queued
        request's deadline, or None. The hold may spend at most HALF
        the request's deadline budget — the other half is reserved for
        the solve itself. Holding until exactly the deadline (round-3
        bug) guaranteed a solo urgent request was dequeued microseconds
        past its deadline and shed."""
        _, req, t_arr = item
        dl = req.get("deadline_ms") if isinstance(req, dict) else None
        if dl is None:
            return None
        try:
            return t_arr + float(dl) / 2e3
        except (TypeError, ValueError):
            return None

    def _drain(self):
        """Collect the next coalescing batch: block for the first
        request, then hold the window (or just drain) for followers.
        A queued request's ``deadline_ms`` PULLS the window close
        earlier — to half its deadline budget, leaving the other half
        for the solve — so urgent requests shrink the hold instead of
        waiting out (or dying inside) the full window."""
        item = self.q.get()
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.window
        dl = self._req_pull_close(item)
        if dl is not None:
            deadline = min(deadline, dl)
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self.q.get(timeout=remaining) if remaining > 0
                       else self.q.get_nowait())
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
            dl = self._req_pull_close(nxt)
            if dl is not None:
                deadline = min(deadline, dl)
        return batch

    def _solver_loop(self):
        while not self.stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            # shed expired requests before touching the device: with a
            # backed-up queue, device time spent on an answer past its
            # deadline is pure waste (the caller already moved on)
            now = time.monotonic()
            live = []
            for entry, req, t_arr in batch:
                dl = req.get("deadline_ms") if isinstance(req, dict) \
                    else None
                if dl is not None:
                    try:
                        expired = (now - t_arr) > float(dl) / 1e3
                    except (TypeError, ValueError):
                        expired = False
                    if expired:
                        with self.stats_lock:
                            self.stats["deadline_shed"] += 1
                        resp = {"error": "deadline exceeded",
                                "deadline_exceeded": True,
                                "queued_ms": round(1e3 * (now - t_arr),
                                                   3)}
                        if "id" in req:
                            resp["id"] = req["id"]
                        self._send(entry, resp)
                        continue
                live.append((entry, req))
            # group coalescible requests by signature
            groups: dict = {}
            singles = []
            for entry, req in live:
                try:
                    key = _coalesce_key(req)
                except Exception as e:
                    self._send(entry, self._err(req, e))
                    continue
                if key is None:
                    singles.append((entry, req))
                else:
                    groups.setdefault(key, []).append((entry, req))
            for key, members in groups.items():
                if len(members) == 1:
                    singles.extend(members)
                    continue
                try:
                    resps = _solve_group(self.ctrl,
                                         [r for _, r in members])
                    with self.stats_lock:
                        self.stats["requests"] += len(members)
                        self.stats["coalesced_batches"] += 1
                        self.stats["max_coalesce"] = max(
                            self.stats["max_coalesce"], len(members))
                    for (entry, req), resp in zip(members, resps):
                        if "id" in req:
                            resp["id"] = req["id"]
                        self._send(entry, resp)
                except Exception as e:
                    # fall back to individual solves: one bad request
                    # must not poison its batch-mates
                    singles.extend(members)
                    del e
            for entry, req in singles:
                try:
                    resp = _solve_one(self.ctrl, req)
                    if "id" in req:
                        resp["id"] = req["id"]
                    with self.stats_lock:
                        self.stats["requests"] += 1
                    self._send(entry, resp)
                except Exception as e:
                    self._send(entry, self._err(req, e))

    def _err(self, req, e):
        with self.stats_lock:
            self.stats["errors"] += 1
        resp = {"error": f"{type(e).__name__}: {e}"}
        if isinstance(req, dict) and "id" in req:
            resp["id"] = req["id"]
        return resp

    def serve_forever(self):
        solver = threading.Thread(target=self._solver_loop, daemon=True)
        solver.start()
        self.srv.settimeout(0.25)
        print(json.dumps({**self.ready, "tcp_port": self.port}),
              flush=True)
        try:
            while not self.stop.is_set():
                try:
                    conn, _ = self.srv.accept()
                except socket.timeout:
                    continue
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                threading.Thread(target=self._reader, args=(conn,),
                                 daemon=True).start()
        finally:
            self.srv.close()


def _stdin_loop(ctrl, ready):
    print(json.dumps(ready), flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad json: {e}"}), flush=True)
            continue
        if req.get("cmd") == "quit":
            break
        if req.get("cmd") == "ping":
            print(json.dumps({"pong": True}), flush=True)
            continue
        try:
            resp = _solve_one(ctrl, req)
            if "id" in req:
                resp["id"] = req["id"]
            print(json.dumps(resp), flush=True)
        except Exception as e:  # keep serving on bad requests
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pyhybridcontrol_tpu.serve")
    ap.add_argument("--config", required=True)
    ap.add_argument("--solver", default="bnb",
                    choices=["bnb", "enumerate", "stagewise"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; without it the server refuses "
                         "a CPU-only JAX")
    ap.add_argument("--tcp", type=int, default=None, metavar="PORT",
                    help="serve line-delimited JSON on a TCP socket "
                         "(0 = ephemeral; the chosen port is printed in "
                         "the ready line) with cross-client request "
                         "coalescing")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--coalesce-window", type=float, default=2.0,
                    metavar="MS", help="hold a coalescing batch open "
                    "this long after its first request (TCP mode; 0 = "
                    "batch only what is already queued)")
    ap.add_argument("--max-batch", type=int, default=256,
                    help="coalescing batch cap (TCP mode)")
    args = ap.parse_args(argv)

    import jax

    from pyhybridcontrol_tpu.utils.runtime import (
        enable_compile_cache, require_accelerator)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    require_accelerator(allow_cpu=args.cpu)
    enable_compile_cache()
    ctrl, ready = _build_controller(args)
    if args.tcp is None:
        _stdin_loop(ctrl, ready)
    else:
        _TcpServer(ctrl, ready, args.host, args.tcp,
                   args.coalesce_window, args.max_batch).serve_forever()


if __name__ == "__main__":
    main()
