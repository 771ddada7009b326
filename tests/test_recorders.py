"""Recorder/IO layout tests: the on-disk tree must match the reference
(``energy.dat``, ``trajectories/<c>/trajectory.dat``, ``parameters/<k>/...``,
``summary.log`` — SURVEY §5 "Metrics / logging")."""

import os

import numpy as np

import montecarlo_tpu as mc
from montecarlo_tpu.models import particle1d as p1d


def _sim(tmp_path, **kw):
    system = p1d.make_system()
    chains = p1d.init_chains(3, beta=2.0, seed=1)
    pool = (p1d.displacement_move(sigma=0.5),)
    steps = 50
    times = mc.build_schedule(steps, 10, 10)
    algos = [
        dict(algorithm=mc.Metropolis, pool=pool, seed=42),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(p1d.callback_energy, mc.callback_acceptance),
             scheduler=times, **kw.get("cb", {})),
        dict(algorithm=mc.StoreTrajectories, scheduler=times),
        dict(algorithm=mc.StoreParameters, dependencies=(mc.Metropolis,),
             scheduler=times),
        dict(algorithm=mc.StoreLastFrames, scheduler=np.asarray([steps])),
        dict(algorithm=mc.PrintTimeSteps,
             scheduler=mc.build_schedule(steps, 0, 25)),
    ]
    sim = mc.Simulation(system, chains, algos, steps,
                        path=str(tmp_path / "run"))
    sim.run()
    return sim, str(tmp_path / "run")


def test_layout_matches_reference(tmp_path):
    sim, path = _sim(tmp_path)
    assert os.path.exists(os.path.join(path, "energy.dat"))
    assert os.path.exists(os.path.join(path, "acceptance.dat"))
    for c in (1, 2, 3):
        assert os.path.exists(
            os.path.join(path, "trajectories", str(c), "trajectory.dat"))
        assert os.path.exists(
            os.path.join(path, "trajectories", str(c), "lastframe.dat"))
    assert os.path.exists(
        os.path.join(path, "parameters", "1", "parameters.dat"))
    log = open(os.path.join(path, "summary.log")).read()
    assert "SIMULATION SUMMARY" in log
    assert "Number of chains: 3" in log
    assert "Metropolis" in log
    assert "Status: Completed" in log


def test_store_first_flag(tmp_path):
    _, path = _sim(tmp_path)
    E = np.loadtxt(os.path.join(path, "energy.dat"))
    assert E[0, 0] == 0  # store_first default True -> t=0 row
    times = mc.build_schedule(50, 10, 10)
    assert E.shape[0] == len(times) + 1


def test_trajectory_format_roundtrip(tmp_path):
    sim, path = _sim(tmp_path)
    system = sim.system
    lines = open(os.path.join(
        path, "trajectories", "1", "trajectory.dat")).read().strip().split("\n")
    ts = []
    for ln in lines:
        t, x = system.parse_frame(ln)
        ts.append(t)
        assert np.isfinite(x)
    assert ts == [0] + list(mc.build_schedule(50, 10, 10))


def test_acceptance_callback_value(tmp_path):
    _, path = _sim(tmp_path)
    A = np.loadtxt(os.path.join(path, "acceptance.dat"))
    # t=0 row: zero-attempt entries are excluded from the mean (guarded
    # 0/0 — the reference's own t=0 value is Julia NaN; VERDICT r4 asked
    # for the where(tot>0) guard)
    assert A[0, 1] == 0.0
    assert np.all(np.isfinite(A[1:, 1]))
    assert np.all((A[1:, 1] > 0) & (A[1:, 1] <= 1))


def test_observable_buffering_consistency(tmp_path):
    """Dense uniform schedule (buffered scan path) and sparse irregular
    schedule (per-event path) must record identical values at shared times."""
    system = p1d.make_system()
    chains = p1d.init_chains(4, beta=2.0, seed=1)
    pool = (p1d.displacement_move(sigma=0.5),)
    steps = 200

    dense = mc.build_schedule(steps, 0, 1)  # every step -> buffered
    sparse = np.asarray([7, 30, 100, 150, 177])  # irregular -> per-event

    outs = {}
    for name, sched in (("dense", dense), ("sparse", sparse)):
        p = str(tmp_path / name)
        sim = mc.Simulation(system, chains, [
            dict(algorithm=mc.Metropolis, pool=pool, seed=42),
            dict(algorithm=mc.StoreCallbacks,
                 callbacks=(p1d.callback_energy,), scheduler=sched),
        ], steps, path=p)
        sim.run()
        E = np.loadtxt(os.path.join(p, "energy.dat"))
        outs[name] = dict(zip(E[:, 0].astype(int), E[:, 1]))
    for t in sparse:
        np.testing.assert_allclose(outs["dense"][t], outs["sparse"][t],
                                   rtol=1e-6)


def test_chain_major_store_roundtrip_at_1e4_chains(tmp_path):
    """BASELINE config 2's recorder layer at flagship chain counts: the
    chain-major BIN store handles M = 10^4 chains (a file per chain is
    impossible there) and round-trips through the memmap loader."""
    M, steps, stride = 10_000, 64, 4
    system = p1d.make_system()
    chains = p1d.init_chains(M, beta=2.0, seed=3)
    pool = (p1d.displacement_move(sigma=0.5),)
    sched = mc.build_schedule(steps, 0, stride)
    path = str(tmp_path / "big")
    sim = mc.Simulation(system, chains, [
        dict(algorithm=mc.Metropolis, pool=pool, seed=42),
        dict(algorithm=mc.StoreCallbacks,
             callbacks=(p1d.callback_energy, mc.callback_acceptance),
             scheduler=sched),
        dict(algorithm=mc.StoreTrajectories, fmt=mc.BIN(),
             scheduler=sched),
    ], steps, path=path)
    sim.run()
    ts, fields = mc.load_chain_major_trajectories(path)
    # store_first default True -> t=0 row; scheduler's own t=0 entry fires
    # only through store_first (events are t > 0)
    want_ts = [0] + [int(t) for t in sched if t > 0]
    assert ts.tolist() == want_ts
    x = fields["frame"]
    assert x.shape == (len(want_ts), M)
    # final record is exactly the final device state
    np.testing.assert_array_equal(
        np.asarray(x[-1]), np.asarray(sim.device_state["sys"].x))
    # equilibrium moments across the 10^4 chains (tail records)
    tail = np.asarray(x[len(want_ts) // 2:]).ravel()
    assert abs(tail.mean()) < 0.02
    np.testing.assert_allclose(tail.std(), 1 / np.sqrt(2 * 2.0), atol=0.02)


def test_chain_major_matches_text_layout(tmp_path):
    """Same run recorded through the reference text layout and the BIN
    chain-major layout produces identical values."""
    M, steps = 4, 40
    system = p1d.make_system()
    sched = mc.build_schedule(steps, 0, 10)
    vals = {}
    for name, fmt in (("txt", mc.DAT()), ("bin", mc.BIN())):
        chains = p1d.init_chains(M, beta=2.0, seed=5)
        pool = (p1d.displacement_move(sigma=0.5),)
        path = str(tmp_path / name)
        sim = mc.Simulation(system, chains, [
            dict(algorithm=mc.Metropolis, pool=pool, seed=7),
            dict(algorithm=mc.StoreTrajectories, fmt=fmt, scheduler=sched),
        ], steps, path=path)
        sim.run()
        if name == "txt":
            rows = []
            for c in range(1, M + 1):
                d = np.loadtxt(os.path.join(path, "trajectories", str(c),
                                            "trajectory.dat"))
                rows.append(d[:, 1])
            vals[name] = np.stack(rows, axis=1)   # (T, M)
        else:
            _, fields = mc.load_chain_major_trajectories(path)
            vals[name] = np.asarray(fields["frame"], np.float64)
    np.testing.assert_allclose(vals["txt"], vals["bin"], rtol=0, atol=0)


def test_txt_format(tmp_path):
    system = p1d.make_system()
    chains = p1d.init_chains(2, beta=2.0, seed=1)
    pool = (p1d.displacement_move(sigma=0.5),)
    sim = mc.Simulation(system, chains, [
        dict(algorithm=mc.Metropolis, pool=pool),
        dict(algorithm=mc.StoreTrajectories, fmt=mc.TXT(),
             scheduler=np.asarray([5, 10])),
    ], 10, path=str(tmp_path / "txt"))
    sim.run()
    assert os.path.exists(
        str(tmp_path / "txt" / "trajectories" / "1" / "trajectory.txt"))


def test_throughput_recorder_sanity(tmp_path):
    """Throughput waits for the device (block_until_ready) — assert the
    measured rates are finite, positive, and roughly consistent
    with the wall-clock of the run (VERDICT r4 item 8)."""
    import time
    system = p1d.make_system()
    chains = p1d.init_chains(256, beta=2.0, seed=1)
    pool = (p1d.displacement_move(sigma=0.5),)
    steps = 400
    sim = mc.Simulation(system, chains, [
        dict(algorithm=mc.Metropolis, pool=pool, seed=42),
        dict(algorithm=mc.Throughput,
             scheduler=np.arange(100, steps + 1, 100)),
    ], steps, path=str(tmp_path / "tp"))
    t0 = time.perf_counter()
    sim.run()
    wall = time.perf_counter() - t0
    d = np.loadtxt(str(tmp_path / "tp" / "throughput.dat"))
    assert d.shape == (4, 2)
    assert np.all(np.isfinite(d[:, 1])) and np.all(d[:, 1] > 0)
    # intervals sum to <= total wall clock => implied total steps/s of the
    # measured intervals cannot be wildly above the true rate
    implied_wall = (100 * 256 / d[:, 1]).sum()
    assert implied_wall <= wall * 1.5


def test_chain_major_empty_store_loads(tmp_path):
    """A run that never fires the BIN recorder still writes a manifest and
    loads back as empty arrays (review r5 finding)."""
    system = p1d.make_system()
    chains = p1d.init_chains(2, beta=2.0, seed=1)
    path = str(tmp_path / "empty")
    sim = mc.Simulation(system, chains, [
        dict(algorithm=mc.Metropolis,
             pool=(p1d.displacement_move(sigma=0.5),)),
        dict(algorithm=mc.StoreTrajectories, fmt=mc.BIN(),
             store_first=False, scheduler=np.asarray([0])),
    ], 4, path=path)
    sim.run()
    ts, fields = mc.load_chain_major_trajectories(path)
    assert ts.shape == (0,)
    assert fields == {}
