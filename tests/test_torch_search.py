"""The port's placement search against the JAX package.

The moves and the GA's crossover are numpy in both packages: from equal
generator states they must propose the same placements and leave the
generators in the same state.  The search's accept/reject steps hang on
exact score comparisons (tests/test_golden_metrics.py), so the `search/*`
pins are held exactly where the port reproduces them: three of the four
cells, through the burst kernel's plain version (device="cpu").  The
fourth, spine-leaf min-time, the port does not reproduce, nor does the
reference's own pallas lowering (ROADMAP queue 3); its test names the
comparison whose outcome flips and holds the port to the reference's
pallas run of the same search instead.
"""
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from repro import search as r_search
from repro.core import topology as r_topology
from repro.core import traffic as r_traffic
from repro.search import optimize as r_optimize
from repro_torch import convert, search
from repro_torch.core import topology, traffic
from repro_torch.search import moves, optimize

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "metrics.json").read_text())
TOPOS = ["fat-tree", "spine-leaf", "bcube", "dcell", "pon3", "pon5"]
PATTERN = dict(n_map=4, n_reduce=3, total_gbits=8.0)
# tests/test_golden_metrics.py's pinned runs and envelope
SEARCH_CFG = dict(method="sa", seed=0, generations=2, population=6,
                  iters=1500)
RTOL = 1e-4
REPRODUCED = [("spine-leaf", "energy"), ("pon3", "energy"),
              ("pon3", "time")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these solves run thousands of tiny torch ops,
    which spinning thread pools slow down under parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(name, objective, **kw):
    return search.optimize_placement(
        topology.build(name), traffic.pattern("uniform", **PATTERN),
        objective, **{**SEARCH_CFG, "device": "cpu", **kw})


@pytest.fixture
def dispatches(monkeypatch):
    """Every evaluate_placements call of the port's search, as the list
    of its candidates."""
    calls = []
    real = optimize.evaluate_placements

    def rec(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out

    monkeypatch.setattr(optimize, "evaluate_placements", rec)
    return calls


# ---------------------------------------------------------------------------
# numpy: bitwise the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", TOPOS)
def test_moves_bitwise(name):
    topo, rtopo = topology.build(name), r_topology.build(name)
    pat = traffic.pattern("uniform", **PATTERN)
    pl0 = traffic.sample_placement(topo, pat, np.random.default_rng(7))
    for move in (*moves.MOVES, "propose"):
        fn = getattr(moves, move)
        rfn = getattr(r_search.moves, move)
        rng, rrng = np.random.default_rng(11), np.random.default_rng(11)
        pl, rpl = pl0, convert.placement_from_arrays(
            convert.placement_to_arrays(pl0))
        for _ in range(40):
            pl = fn(pl, topo, rng)
            rpl = rfn(r_traffic.Placement(rpl.mappers, rpl.reducers),
                      rtopo, rrng)
            assert np.array_equal(pl.mappers, rpl.mappers), move
            assert np.array_equal(pl.reducers, rpl.reducers), move
            pl.validate(topo)
        assert (rng.bit_generator.state == rrng.bit_generator.state), move


def test_moves_fall_back_to_swap_when_fully_occupied():
    topo = topology.build("pon3")
    n = len(topo.task_servers)
    pl = traffic.Placement(np.array(topo.task_servers[:n // 2]),
                           np.array(topo.task_servers[n // 2:]))
    for move in ("migrate", "propose"):
        rng, rrng = np.random.default_rng(3), np.random.default_rng(3)
        got = getattr(moves, move)(pl, topo, rng)
        want = moves.swap(pl, topo, rrng) if move == "migrate" else None
        got.validate(topo)
        assert sorted(np.concatenate([got.mappers, got.reducers])) \
            == sorted(topo.task_servers)
        if want is not None:
            assert got.key() == want.key()


@pytest.mark.parametrize("name", ["spine-leaf", "pon3", "dcell"])
def test_crossover_and_tournament_bitwise(name):
    topo, rtopo = topology.build(name), r_topology.build(name)
    pat = traffic.pattern("uniform", **PATTERN)
    src = np.random.default_rng(5)
    pls = [traffic.sample_placement(topo, pat, src) for _ in range(6)]
    rng, rrng = np.random.default_rng(2), np.random.default_rng(2)
    for a, b in zip(pls, pls[1:] + pls[:1]):
        got = optimize._crossover(a, b, topo, rng)
        want = r_optimize._crossover(
            r_traffic.Placement(a.mappers, a.reducers),
            r_traffic.Placement(b.mappers, b.reducers), rtopo, rrng)
        assert got.key() == want.key()
    pop = [optimize.Candidate(pl, None, None, float(s))
           for pl, s in zip(pls, (3.0, 1.0, 2.0, 1.0, 5.0, 4.0))]
    rpop = [r_optimize.Candidate(pl, None, None, c.score)
            for pl, c in zip(pls, pop)]
    for _ in range(10):
        assert (optimize._tournament(pop, rng).placement.key()
                == r_optimize._tournament(rpop, rrng).placement.key())
    assert rng.bit_generator.state == rrng.bit_generator.state


# ---------------------------------------------------------------------------
# the pinned SA runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,objective", REPRODUCED)
def test_golden_search_runs(name, objective):
    want = GOLDEN[f"search/{name}/min-{objective}/sa/seed0"]
    res = run(name, objective)
    res.best.result.certificate.assert_ok(f"search/{name}/min-{objective}")
    assert res.baseline_best == want["baseline_best"]
    assert res.evaluations == want["evaluations"]
    assert res.dispatches == want["dispatches"]
    assert res.best.placement.mappers.tolist() == want["best_mappers"]
    assert res.best.placement.reducers.tolist() == want["best_reducers"]
    np.testing.assert_allclose(res.best.score, want["best_score"], rtol=RTOL)
    np.testing.assert_allclose(res.gain, want["gain"], rtol=RTOL)
    assert res.gain >= 1.0 - 1e-12
    for k in search.BASELINES:
        np.testing.assert_allclose(res.baselines[k].score,
                                   want["baselines"][k], rtol=RTOL)


def test_spine_leaf_time_pin_flips_at_the_seed_incumbent(dispatches):
    """Where the port misses the spine-leaf min-time pin, and why.

    The first comparison whose outcome flips is the seed generation's
    incumbent choice (generation 0), `min(finite, key=score)` over the
    seed population: candidate 2, the "local" baseline, against
    candidate 3, the first random spread.  Both complete in the same
    slot.  In the pinned run "local" scored one ulp above
    (0.2666666666666667 against 0.26666666666666666), so candidate 3 won;
    in the port's run the two tie exactly and `min` keeps the first,
    "local".  Later generations find nothing strictly better, so each
    run keeps its seed incumbent: the scores, gain, counts and every
    baseline still match the pin within RTOL, the best placement does
    not."""
    want = GOLDEN["search/spine-leaf/min-time/sa/seed0"]
    res = run("spine-leaf", "time")
    seed = dispatches[0]
    local, rand0 = seed[2], seed[3]
    assert local.score == rand0.score == want["best_score"]
    assert want["baselines"]["local"] > want["best_score"]
    assert math.nextafter(want["best_score"], 1.0) \
        == want["baselines"]["local"]
    assert rand0.placement.mappers.tolist() == want["best_mappers"]
    assert rand0.placement.reducers.tolist() == want["best_reducers"]
    assert res.best.placement.key() == local.placement.key()
    assert res.best.placement.key() == res.baselines["local"].placement.key()
    assert res.history == [local.score] * 3
    # everything the flip does not decide still holds the pin
    assert res.baseline_best == want["baseline_best"]
    assert (res.evaluations, res.dispatches) == (want["evaluations"],
                                                 want["dispatches"])
    np.testing.assert_allclose(res.best.score, want["best_score"], rtol=RTOL)
    np.testing.assert_allclose(res.gain, want["gain"], rtol=RTOL)
    for k in search.BASELINES:
        np.testing.assert_allclose(res.baselines[k].score,
                                   want["baselines"][k], rtol=RTOL)


def test_spine_leaf_time_matches_reference_pallas():
    """The port against the reference's pallas lowering (Pallas in
    interpret mode) on the search it misses the pin on: the same
    optimized and baseline placements, counts and history, every score
    within RTOL."""
    got = convert.search_result_to_arrays(run("spine-leaf", "time"))
    want = convert.search_result_to_arrays(r_search.optimize_placement(
        r_topology.build("spine-leaf"),
        r_traffic.pattern("uniform", **PATTERN), "time", backend="pallas",
        **SEARCH_CFG))
    for cand in ("best", *(("baselines", k) for k in search.BASELINES)):
        g = got[cand] if cand == "best" else got[cand[0]][cand[1]]
        w = want[cand] if cand == "best" else want[cand[0]][cand[1]]
        assert np.array_equal(g["mappers"], w["mappers"]), cand
        assert np.array_equal(g["reducers"], w["reducers"]), cand
        np.testing.assert_allclose(g["score"], w["score"], rtol=RTOL)
    for k in ("method", "objective", "topo_name", "baseline_best",
              "evaluations", "dispatches"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["gain"], want["gain"], rtol=RTOL)
    np.testing.assert_allclose(got["history"], want["history"], rtol=RTOL)


def test_ga_matches_reference_and_repeats():
    """The GA on pon3 min-energy: two port runs identical, and the
    reference's pallas run's placements, counts and scores (Joules
    there are whole numbers, so no comparison sits on a near-tie)."""
    kw = dict(method="ga", generations=2, population=6)
    a = convert.search_result_to_arrays(run("pon3", "energy", **kw))
    b = convert.search_result_to_arrays(run("pon3", "energy", **kw))
    assert repr(a) == repr(b)
    want = convert.search_result_to_arrays(r_search.optimize_placement(
        r_topology.build("pon3"), r_traffic.pattern("uniform", **PATTERN),
        "energy", backend="pallas", **{**SEARCH_CFG, **kw}))
    assert repr(a) == repr(want)
    assert a["evaluations"] == 6 + 2 * (6 - 2) and a["dispatches"] == 3


def test_search_config_checks_its_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            search.SearchConfig().validate()
    with pytest.raises(ValueError, match="device"):
        search.SearchConfig(device="meta").validate()
    with pytest.raises(ValueError, match="generations"):
        search.SearchConfig(generations=-1, device="cpu").validate()
    with pytest.raises(ValueError, match="unknown method"):
        run("pon3", "energy", method="tabu")
