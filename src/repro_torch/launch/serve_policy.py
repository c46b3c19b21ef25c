"""Policy-service entry point on the port: the checkpoint-interval server
as a process (the counterpart of ``repro.launch.serve_policy``).

Smoke mode exercises all three flows in-process and gates tail latency:

    PYTHONPATH=src python -m repro_torch.launch.serve_policy --smoke \
        [--device cpu]

Server mode speaks newline-delimited JSON over TCP (stdlib only):

    PYTHONPATH=src python -m repro_torch.launch.serve_policy --port 7070 \
        --snapshot-root SNAPSHOT_DIR

The session state lives on CUDA unless ``--device cpu`` is given (and the
entry raises where there is no card).

One request per line: ``{"flow": "query"|"session", "requests": [...]}``
with each request a :meth:`repro_torch.policy.PolicyRequest.to_dict` object,
``{"flow": "calibrate", "mu_true": ..., "n_observations": ...}``,
``{"flow": "stats"}``, or ``{"flow": "snapshot"}``.  One JSON line back:
``{"ok": true, "decisions": [...]}`` (PolicyDecision dicts) or
``{"ok": false, "error": "..."}``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.policy import PolicyRequest
from repro_torch.serve.policy_service import PolicyService


def _build(args: argparse.Namespace) -> PolicyService:
    return PolicyService(
        estimator=args.estimator, max_window=args.max_window,
        lw_key_bits=args.lw_key_bits, snapshot_root=args.snapshot_root,
        device=args.device)


def run_smoke(args: argparse.Namespace) -> int:
    svc = _build(args)

    # calibrate: synthetic truth through the real estimator path.
    rep = svc.calibrate(1.0 / 7200.0, n_observations=128, seed=0)
    print(f"calibrate: mu_true={rep.mu_true:.3e}  mu_hat={rep.mu_hat:.3e}  "
          f"rel_error={rep.rel_error:.3f}  interval={rep.interval:.1f}s  "
          f"oracle={rep.interval_oracle:.1f}s")
    assert np.isfinite(rep.interval) and rep.interval > 0

    # query: a one-shot batch.
    reqs = [PolicyRequest(client=f"q{i}", k=float(4 + i),
                          failures=(1800.0 + 60.0 * i, 5400.0),
                          checkpoint_overheads=(15.0,), now=7200.0)
            for i in range(16)]
    decs = svc.query(reqs)
    print(f"query: {len(decs)} decisions, "
          f"interval[0]={decs[0].interval:.1f}s  mu[0]={decs[0].mu:.3e}")
    assert all(np.isfinite(d.interval) and d.interval > 0 for d in decs)

    # session: streamed rounds with per-flush latency measurement.
    lat = []
    clients = [f"s{i}" for i in range(args.smoke_clients)]
    rng = np.random.default_rng(0)
    for rnd in range(args.smoke_rounds):
        batch = {
            "failures": rng.exponential(3600.0,
                                        (len(clients), 2)) + 1e-3,
            "checkpoint_overheads": rng.exponential(20.0, len(clients)),
            "restores": np.where(rng.random(len(clients)) < 0.5,
                                 rng.exponential(50.0, len(clients)), np.nan),
            "now": np.full(len(clients), (rnd + 1) * 1800.0),
        }
        t0 = time.perf_counter()
        db = svc.session_update_arrays(clients, **batch)
        lat.append(time.perf_counter() - t0)
        assert np.all(np.isfinite(db.interval)) and np.all(db.interval > 0)
    p50, p99 = np.percentile(lat, [50, 99])
    per_client_p99 = p99 / len(clients)
    print(f"session on {svc.device}: {args.smoke_rounds} flushes x "
          f"{len(clients)} clients  "
          f"p50={p50 * 1e3:.2f}ms  p99={p99 * 1e3:.2f}ms  "
          f"({per_client_p99 * 1e6:.1f}us/client at p99)")
    st = svc.stats()
    print(f"stats: {st}")

    if args.snapshot_root:
        path = svc.snapshot()
        svc2 = PolicyService.restore_latest(args.snapshot_root,
                                            device=args.device)
        d1 = svc.session_update_arrays(clients[:4], now=np.full(4, 1e6))
        d2 = svc2.session_update_arrays(clients[:4], now=np.full(4, 1e6))
        resumed = bool(np.array_equal(d1.interval, d2.interval))
        print(f"snapshot: {path}  resume-bitwise={resumed}")
        assert resumed

    # Generous in-process bound: a flush of the whole smoke fleet must
    # stay under p99_budget (CI gate; typical is ~100x below).
    assert p99 < args.p99_budget, (
        f"session flush p99 {p99:.3f}s exceeds budget {args.p99_budget}s")
    print("policy-service smoke OK")
    return 0


def run_server(args: argparse.Namespace) -> int:
    import socketserver

    svc = _build(args)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    out = self._dispatch(json.loads(line))
                except Exception as e:  # malformed input must not kill the server
                    out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                self.wfile.write((json.dumps(out) + "\n").encode())
                self.wfile.flush()

        def _dispatch(self, msg: dict) -> dict:
            flow = msg.get("flow")
            if flow in ("query", "session"):
                reqs = [PolicyRequest.from_dict(d) for d in msg["requests"]]
                decs = (svc.query if flow == "query" else svc.session)(reqs)
                return {"ok": True, "decisions": [d.to_dict() for d in decs]}
            if flow == "calibrate":
                rep = svc.calibrate(
                    float(msg["mu_true"]),
                    n_observations=int(msg.get("n_observations", 64)),
                    seed=int(msg.get("seed", 0)))
                return {"ok": True, "mu_hat": rep.mu_hat,
                        "rel_error": rep.rel_error, "interval": rep.interval,
                        "interval_oracle": rep.interval_oracle}
            if flow == "stats":
                return {"ok": True, **svc.stats()}
            if flow == "snapshot":
                return {"ok": True, "path": svc.snapshot()}
            return {"ok": False, "error": f"unknown flow {flow!r}"}

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((args.host, args.port), Handler) as srv:
        print(f"policy service on {args.host}:{args.port} "
              f"(estimator={args.estimator}, lw_key_bits={args.lw_key_bits}, "
              f"device={svc.device})", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run all three flows in-process and gate p99")
    ap.add_argument("--port", type=int, default=0,
                    help="serve newline-JSON over TCP on this port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--estimator", choices=("windowed", "moment"),
                    default="windowed")
    ap.add_argument("--max-window", type=int, default=256)
    ap.add_argument("--lw-key-bits", type=int, default=None,
                    help="Lambert-W cache quantization (default: exact keys)")
    ap.add_argument("--snapshot-root", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the session state (default: cuda)")
    ap.add_argument("--smoke-clients", type=int, default=2048)
    ap.add_argument("--smoke-rounds", type=int, default=8)
    ap.add_argument("--p99-budget", type=float, default=2.0,
                    help="smoke gate: max allowed p99 flush latency (s)")
    args = ap.parse_args(argv)
    if args.smoke:
        return run_smoke(args)
    if args.port:
        return run_server(args)
    ap.error("pick --smoke or --port")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
