"""The port's policy surface and service (``repro_torch.policy``,
``repro_torch.core.replication``, ``repro_torch.serve.policy_service``,
``repro_torch.launch.serve_policy``) against the JAX package on the CPU.

The service holds its session state as tensors on its device; every
decision must be bitwise the reference service's (``interval``, ``mu``,
``V``, ``T_d`` as float64 bit patterns; ``n_failures`` and ``clamped``
equal) on ``synthetic_stream`` in both estimator forms and both Lambert-W
cache modes, on typed query/session batches (duplicates folding in
arrival order), and on the stream a simulated job fed its controller
(within 1e-13 relative of the controller itself, whose Python ``sum``
compensates rounding since Python 3.12).  A
snapshot written by the reference service restores in the port and the
stream continues bitwise (and the other way round).  ``best_replication``,
``plan_replication`` and ``effective_failure_rate`` match the
reference's (the failure rates exactly; the utilization reports within
1e-12 relative of the reference's evaluated in float64, under
``jax.enable_x64``: JAX's default float32 is 1% off at small k*mu).
"""
import json
import math
import socket
import struct
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.replication as R_rep
import repro.policy as R_pol
import repro.serve.policy_service as R_svc
from repro.core.adaptive import AdaptiveCheckpointController as R_Ctl
import repro_torch.core.replication as T_rep
import repro_torch.policy as T_pol
import repro_torch.serve.policy_service as T_svc
from repro_torch.core.adaptive import AdaptiveCheckpointController
from repro_torch.launch import serve_policy as T_launch
from repro_torch.sim.job import AdaptivePolicy, simulate_job
from repro_torch.sim.network import ChurnNetwork, constant_mtbf

CPU = "cpu"
FIELDS = ("interval", "mu", "V", "T_d", "n_failures", "clamped")
ROOT = Path(__file__).resolve().parents[1]


def bits(x: float) -> bytes:
    return struct.pack("<d", float(x))


def _same_batch(a, b) -> None:
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _same_decisions(a, b) -> None:
    assert len(a) == len(b)
    for d, e in zip(a, b):
        for f in ("interval", "mu", "V", "T_d"):
            assert bits(getattr(d, f)) == bits(getattr(e, f)), (d.client, f)
        assert (d.n_failures, d.clamped, d.client) == \
            (e.n_failures, e.clamped, e.client)


def _services(**kw):
    return R_svc.PolicyService(**kw), T_svc.PolicyService(device=CPU, **kw)


def _requests(seed=3, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nf = int(rng.integers(0, 40))
        out.append(dict(
            client=f"c{i}", k=float(rng.integers(1, 64)),
            failures=tuple(float(x) for x in rng.exponential(3600, nf) + 1e-3),
            checkpoint_overheads=tuple(
                float(x) for x in rng.exponential(20, int(rng.integers(0, 5)))),
            restores=tuple(
                float(x) for x in rng.exponential(50, int(rng.integers(0, 3)))),
            now=float(rng.uniform(0, 1e5)) if rng.random() < 0.7 else None,
            exposure_peers=float(rng.integers(1, 9))
            if rng.random() < 0.3 else None,
            window=int(rng.integers(1, 48)),
            prior_count=int(rng.integers(0, 6))))
    return out


# --------------------------------------------------------------------------- #
# Bitwise against the reference service                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("estimator", ["windowed", "moment"])
@pytest.mark.parametrize("key_bits", [None, 12])
def test_session_stream_bitwise_equals_the_reference(estimator, key_bits):
    r, t = _services(estimator=estimator, max_window=32,
                     lw_key_bits=key_bits)
    clients = [f"c{i}" for i in range(1500)]
    kw = dict(k=8.0, window=32, prior_mu=1 / 7200.0)
    stream = dict(n_clients=1500, n_rounds=5, mix="boinc", seed=1)
    for ba, bb in zip(R_svc.synthetic_stream("diurnal", **stream),
                      T_svc.synthetic_stream("diurnal", **stream)):
        for k in ba:
            assert np.array_equal(ba[k], bb[k], equal_nan=True), k
        _same_batch(
            r.session_update_arrays(clients, template=R_pol.PolicyRequest(
                **kw), **ba),
            t.session_update_arrays(clients, template=T_pol.PolicyRequest(
                **kw), **bb))
    st_r, st_t = r.stats(), t.stats()
    for k in ("n_sessions", "n_rows", "decisions", "lw_hits", "lw_misses"):
        assert st_r[k] == st_t[k], k
    assert st_t["device"] == CPU


@pytest.mark.parametrize("estimator", ["windowed", "moment"])
def test_failure_counts_and_ticks_with_exposure(estimator):
    r, t = _services(estimator=estimator, max_window=32)
    rng = np.random.default_rng(4)
    clients = [f"x{i}" for i in range(300)]
    for rnd in range(6):
        fails = rng.exponential(2000.0, (300, 5)) + 1e-3
        counts = rng.integers(0, 6, 300)
        now = np.where(rng.random(300) < 0.8, (rnd + 1) * 900.0
                       - rng.uniform(0, 2000, 300), np.nan)
        peers = rng.integers(1, 12, 300).astype(float)
        over = rng.exponential(15.0, (300, 2))
        kw = dict(failures=fails, failure_counts=counts,
                  checkpoint_overheads=over, now=now, exposure_peers=peers)
        _same_batch(r.session_update_arrays(clients, **kw),
                    t.session_update_arrays(clients, **kw))


@pytest.mark.parametrize("estimator", ["windowed", "moment"])
def test_query_and_session_bitwise_equal_the_reference(estimator):
    reqs = _requests()
    r, t = _services(estimator=estimator)
    _same_decisions(r.query([R_pol.PolicyRequest(**q) for q in reqs]),
                    t.query([T_pol.PolicyRequest(**q) for q in reqs]))
    # duplicates fold in arrival order, in passes
    r, t = _services(estimator=estimator)
    _same_decisions(r.session([R_pol.PolicyRequest(**q) for q in reqs] * 2),
                    t.session([T_pol.PolicyRequest(**q) for q in reqs] * 2))


def test_query_matches_the_scalar_controller():
    """The scalar path (``decide``) is bitwise the reference's.  The
    service sums each window sequentially, as the reference service does;
    the controller sums with Python's ``sum``, which since Python 3.12
    compensates rounding, so the two differ in the last bit of ``mu``
    (the reference service and controller differ the same way): ``mu``
    held at 1e-15 relative and the interval, which the W0 solve's slope
    near its branch point amplifies, at 1e-13; exact everywhere else."""
    reqs = [T_pol.PolicyRequest(**q) for q in _requests(seed=8)]
    decs = T_svc.PolicyService(device=CPU).query(reqs)
    ref_decs = R_svc.PolicyService().query(
        [R_pol.PolicyRequest(**r.to_dict()) for r in reqs])
    _same_decisions(ref_decs, decs)
    for r, d in zip(reqs, decs):
        ref = T_pol.decide(r)
        rd = R_pol.decide(R_pol.PolicyRequest(**r.to_dict()))
        assert ref.to_dict() == rd.to_dict()
        assert math.isclose(d.mu, ref.mu, rel_tol=1e-15), r.client
        assert math.isclose(d.interval, ref.interval, rel_tol=1e-13), \
            r.client
        assert (d.V, d.T_d, d.n_failures) == (ref.V, ref.T_d, ref.n_failures)


class RecordingPolicy:
    """Wraps the sim's AdaptivePolicy, logging the event stream between
    consecutive interval() calls plus every interval it commits."""

    def __init__(self, inner):
        self.inner = inner
        self.rounds = []
        self._f, self._o, self._r = [], [], []

    def tick(self, now, exposure_peers=None):
        self.inner.tick(now, exposure_peers)

    def interval(self):
        iv = self.inner.interval()
        self.rounds.append((tuple(self._f), tuple(self._o), tuple(self._r),
                            iv))
        self._f, self._o, self._r = [], [], []
        return iv

    def on_checkpoint(self, overhead):
        self._o.append(overhead)
        self.inner.on_checkpoint(overhead)

    def on_restore(self, downtime):
        self._r.append(downtime)
        self.inner.on_restore(downtime)

    def on_observation(self, lifetime):
        self._f.append(lifetime)
        self.inner.on_observation(lifetime)


@pytest.mark.parametrize("seed,mtbf", [(0, 1800.0), (1, 600.0), (7, 7200.0)])
def test_service_replays_a_simulate_job_stream(seed, mtbf):
    """Replay the stream a simulated job fed its controller through both
    services: every decision bitwise the reference service's, and within
    1e-13 relative of the interval the controller committed (see
    ``test_query_matches_the_scalar_controller``)."""
    net = ChurnNetwork(64, constant_mtbf(mtbf), np.random.default_rng(seed))
    ctl = AdaptiveCheckpointController(k=8, prior_mu=1 / 3600.0)
    rec = RecordingPolicy(AdaptivePolicy(ctl))
    simulate_job(network=net, policy=rec, k=8, work_required=6 * 3600.0,
                 V=20.0, T_d=50.0, max_wall_time=48 * 3600.0)
    assert len(rec.rounds) > 5
    r, t = _services()
    for fails, overs, rests, iv in rec.rounds:
        kw = dict(client="job", k=8.0, failures=fails,
                  checkpoint_overheads=overs, restores=rests,
                  prior_mu=1 / 3600.0, prior_v=ctl.prior_v,
                  window=ctl.mu_window, ema_alpha=ctl.ema_alpha,
                  prior_count=ctl.prior_count,
                  min_interval=ctl.min_interval,
                  max_interval=ctl.max_interval)
        d = t.session([T_pol.PolicyRequest(**kw)])
        _same_decisions(r.session([R_pol.PolicyRequest(**kw)]), d)
        assert math.isclose(d[0].interval, iv, rel_tol=1e-13)


# --------------------------------------------------------------------------- #
# Snapshots: the reference's format, both ways                                #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("estimator", ["windowed", "moment"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_implementations(tmp_path, estimator,
                                                  writer):
    root = str(tmp_path / "snaps")
    r, t = _services(estimator=estimator, max_window=32, snapshot_root=root)
    clients = [f"c{i}" for i in range(200)]
    for ba in R_svc.synthetic_stream("diurnal", n_clients=200, n_rounds=3,
                                     seed=9):
        _same_batch(r.session_update_arrays(clients, **ba),
                    t.session_update_arrays(clients, **ba))
    (r if writer == "reference" else t).snapshot()
    r2 = R_svc.PolicyService.restore_latest(root)
    t2 = T_svc.PolicyService.restore_latest(root, device=CPU)
    assert t2.stats()["n_sessions"] == 200
    assert t2.counters == r2.counters
    for ba in R_svc.synthetic_stream("diurnal", n_clients=200, n_rounds=2,
                                     seed=10):
        d = r.session_update_arrays(clients, **ba)
        _same_batch(d, r2.session_update_arrays(clients, **ba))
        _same_batch(d, t2.session_update_arrays(clients, **ba))
        _same_batch(d, t.session_update_arrays(clients, **ba))


def test_snapshot_is_atomic_across_steps(tmp_path):
    root = str(tmp_path / "snaps")
    svc = T_svc.PolicyService(snapshot_root=root, device=CPU)
    svc.session([T_pol.PolicyRequest(client="a", failures=(100.0,))])
    p1 = svc.snapshot()
    svc.session([T_pol.PolicyRequest(client="a", failures=(200.0,))])
    p2 = svc.snapshot()
    assert p1 != p2
    svc2 = T_svc.PolicyService.restore_latest(root, device=CPU)
    assert svc2.session([T_pol.PolicyRequest(client="a")])[0].n_failures == 2
    with pytest.raises(FileNotFoundError):
        T_svc.PolicyService.restore_latest(str(tmp_path / "none"), device=CPU)


# --------------------------------------------------------------------------- #
# Flows and the typed surface                                                 #
# --------------------------------------------------------------------------- #

def test_query_interval_clamped_and_flagged():
    svc = T_svc.PolicyService(device=CPU)
    lo = svc.query([T_pol.PolicyRequest(
        k=64.0, failures=(0.5,) * 32, window=32, min_interval=30.0)])[0]
    assert lo.interval == 30.0 and lo.clamped
    hi = svc.query([T_pol.PolicyRequest(
        k=1.0, failures=(1e9,), window=4, max_interval=3600.0)])[0]
    assert hi.interval == 3600.0 and hi.clamped


def test_calibrate_matches_the_reference():
    tpl = dict(window=64, prior_count=0)
    a = R_svc.PolicyService().calibrate(
        1 / 3600.0, n_observations=64, seed=0,
        template=R_pol.PolicyRequest(**tpl))
    b = T_svc.PolicyService(device=CPU).calibrate(
        1 / 3600.0, n_observations=64, seed=0,
        template=T_pol.PolicyRequest(**tpl))
    for f in ("mu_hat", "rel_error", "interval", "interval_oracle"):
        assert bits(getattr(a, f)) == bits(getattr(b, f)), f
    assert b.decision.client == "calibrate" and b.rel_error < 0.5


def test_service_rejects_bad_input_like_the_reference():
    svc = T_svc.PolicyService(device=CPU, max_window=32)
    with pytest.raises(ValueError, match="duplicate clients"):
        svc.session_update_arrays(["a", "a"], now=np.asarray([1.0, 2.0]))
    with pytest.raises(ValueError, match="max_window"):
        svc.session([T_pol.PolicyRequest(client="w", window=33)])
    with pytest.raises(ValueError, match="finite"):
        svc.session_update_arrays(["b"], failures=np.asarray([[np.inf]]))
    with pytest.raises(ValueError, match="positive"):
        svc.session_update_arrays(["c"], failures=np.asarray([[-1.0]]))
    with pytest.raises(ValueError, match="exposure_peers"):
        svc.session_update_arrays(["d"], now=np.asarray([5.0]),
                                  exposure_peers=np.asarray([0.0]))
    with pytest.raises(ValueError, match="estimator"):
        T_svc.PolicyService(estimator="median", device=CPU)
    svc.session([T_pol.PolicyRequest(client="e", failures=(100.0,))])
    assert svc.end_session("e") and not svc.end_session("e")
    assert svc.session([T_pol.PolicyRequest(client="e")])[0].n_failures == 0


def test_empty_batches_match_the_reference():
    r, t = _services()
    kw = dict(failures=np.zeros((0, 2)), checkpoint_overheads=np.zeros(0),
              restores=np.zeros(0), now=np.zeros(0))
    _same_batch(r.session_update_arrays([], **kw),
                t.session_update_arrays([], **kw))
    assert t.query([]) == [] and t.session([]) == []


def test_request_decision_wire_forms_match_the_reference():
    req = T_pol.PolicyRequest(client="x", failures=(1.0, 2.0), now=3.0)
    assert T_pol.PolicyRequest.from_dict(req.to_dict()) == req
    assert req.to_dict() == R_pol.PolicyRequest(
        client="x", failures=(1.0, 2.0), now=3.0).to_dict()
    dec = T_pol.PolicyDecision(interval=10.0, mu=1e-4, V=5.0, T_d=7.0)
    assert T_pol.PolicyDecision.from_dict(dec.to_dict()) == dec
    with pytest.raises(ValueError, match="unknown PolicyRequest fields"):
        T_pol.PolicyRequest.from_dict({"nope": 1})
    for bad in (dict(k=0.0), dict(failures=(-1.0,)), dict(window=0),
                dict(min_interval=10.0, max_interval=1.0),
                dict(exposure_peers=0.0), dict(prior_mu=0.0)):
        with pytest.raises(ValueError):
            T_pol.PolicyRequest(**bad)


def test_controller_for_matches_the_reference():
    for q in _requests(seed=12, n=12):
        q.pop("exposure_peers")
        t_ctl = T_pol.controller_for(T_pol.PolicyRequest(**q))
        r_ctl = R_pol.controller_for(R_pol.PolicyRequest(**q))
        T_pol.apply_request(t_ctl, T_pol.PolicyRequest(**q))
        R_pol.apply_request(r_ctl, R_pol.PolicyRequest(**q))
        a = T_pol.decision_from_controller(t_ctl, client="z")
        b = R_pol.decision_from_controller(r_ctl, client="z")
        assert a.to_dict() == b.to_dict()
        assert isinstance(r_ctl, R_Ctl)


# --------------------------------------------------------------------------- #
# Replication plans                                                           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("mu,k,V,T_d,t_repair", [
    (1 / 3600.0, 16, 20.0, 50.0, 300.0),
    (1 / 600.0, 64, 30.0, 120.0, 60.0),
    (1 / 86400.0, 4, 5.0, 10.0, 900.0),
    (1 / 200.0, 128, 60.0, 200.0, 30.0),
])
def test_replication_plans_match_the_reference(mu, k, V, T_d, t_repair):
    for R in (1, 2, 3, 4):
        for exact in (False, True):
            assert T_rep.effective_failure_rate(mu, R, t_repair, exact) == \
                R_rep.effective_failure_rate(mu, R, t_repair, exact)
        with jax.enable_x64(True):
            a = R_rep.plan_replication(mu, k, V, T_d, R, t_repair)
        b = T_rep.plan_replication(mu, k, V, T_d, R, t_repair)
        assert (b.R, b.t_repair, b.mu_eff, b.overhead_factor) == \
            (a.R, a.t_repair, a.mu_eff, a.overhead_factor)
        assert b.report.feasible == a.report.feasible
        for f in ("lam_star", "interval_star", "U_star"):
            assert math.isclose(getattr(b.report, f), getattr(a.report, f),
                                rel_tol=1e-12), f
    with jax.enable_x64(True):
        best_r = R_rep.best_replication(mu, k, V, T_d, t_repair)
    best_t = T_rep.best_replication(mu, k, V, T_d, t_repair)
    assert best_t.R == best_r.R
    assert math.isclose(best_t.effective_throughput,
                        best_r.effective_throughput, rel_tol=1e-12)
    with pytest.raises(ValueError):
        T_rep.effective_failure_rate(mu, 0, t_repair)


# --------------------------------------------------------------------------- #
# Entry point                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("estimator", ["windowed", "moment"])
def test_launch_serve_policy_smoke_on_cpu(tmp_path, capsys, estimator):
    rc = T_launch.main(["--smoke", "--device", CPU, "--estimator", estimator,
                        "--smoke-clients", "256", "--smoke-rounds", "4",
                        "--snapshot-root", str(tmp_path / "s")])
    out = capsys.readouterr().out
    assert rc == 0
    assert "resume-bitwise=True" in out and "policy-service smoke OK" in out
    assert "session on cpu" in out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launch_serve_policy_tcp_server_answers(tmp_path):
    port = _free_port()
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_policy", "--port",
         str(port), "--device", CPU, "--snapshot-root", str(tmp_path / "s")],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, text=True)
    try:
        assert "policy service on" in proc.stdout.readline()
        with socket.create_connection(("127.0.0.1", port), timeout=30) as c:
            f = c.makefile("rw")
            req = T_pol.PolicyRequest(client="a", k=8.0,
                                      failures=(1800.0, 5400.0), now=7200.0)
            for msg in ({"flow": "session", "requests": [req.to_dict()]},
                        {"flow": "stats"}, {"flow": "snapshot"},
                        {"flow": "bogus"}):
                f.write(json.dumps(msg) + "\n")
                f.flush()
            got = [json.loads(f.readline()) for _ in range(4)]
        want = R_pol.decide(R_pol.PolicyRequest(**req.to_dict())).to_dict()
        assert got[0]["ok"] and got[0]["decisions"][0] == want
        assert got[1]["ok"] and got[1]["n_sessions"] == 1
        assert got[2]["ok"] and got[3] == {"ok": False,
                                           "error": "unknown flow 'bogus'"}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_service_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "runs the service on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_svc.PolicyService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_launch.main(["--smoke"])
