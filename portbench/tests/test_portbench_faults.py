"""The harness's output check, driven on the CPU at a tiny size with the
look for a card skipped: sound runs come out correct, and a run with
the timed path broken underneath comes out not correct, once for each
fault a cell can have."""
from unittest import mock

import numpy as np
import pytest

import repro_torch.core.solver as solver
import repro_torch.kernels.ops as ops
from portbench.drivers import common
from portbench.tests import tiny

CELLS = sorted(tiny.TINY)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = tiny.run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


BURST = ops.pdhg_coo_burst


def _in_window(fault, original):
    """`fault` in the window, `original` in set-up: a driver's set-up ends
    in common.sync, which turns the fault on."""
    on = {"window": False}

    def call(*a, **kw):
        return (fault if on["window"] else original)(*a, **kw)

    def sync(ctx):
        on["window"] = True
        return SYNC(ctx)
    return call, mock.patch.object(common, "sync", sync)


SYNC = common.sync


def _unchanged_state(*a, iters, **kw):
    # a burst that returns the state it was given
    return BURST(*a, iters=0, **kw)


def _half_left_out(x):
    x = x.copy()
    x[1::2] = 0.0                         # every other flow left out
    return x


def _altered(x):
    if x.any():
        x = x.copy()
        f, e, w, t = np.unravel_index(np.argmax(x), x.shape)
        x[f, e, w, t] *= 0.5              # the answer altered as produced
    return x


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_left_out",
                                   "altered_answer"])
def test_fault_is_not_correct(workload, fault):
    if fault == "unchanged_state":
        call, armed = _in_window(_unchanged_state, BURST)
        patch = mock.patch.object(ops, "pdhg_coo_burst", call)
    else:
        pack = solver.temporal_pack
        broken = {"half_left_out": _half_left_out,
                  "altered_answer": _altered}[fault]
        call, armed = _in_window(lambda *a, **kw: broken(pack(*a, **kw)),
                                 pack)
        patch = mock.patch.object(solver, "temporal_pack", call)
    with patch, armed:
        out = tiny.run(workload)
    assert not out["correct"], out["checks"]
