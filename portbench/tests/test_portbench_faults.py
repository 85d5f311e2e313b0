"""A run whose timed path is broken underneath comes out as not correct, for each fault a sort cell can have.

The harness runs as on the card, with the look for a card skipped (the
CPU, a tiny ring), and the window sorts with a broken sort:

  * unchanged: the sort returns its input as it came;
  * half left out: half of the answers are dropped (multiplied by 0);
  * altered: one answer is moved by half the input's gap where it is
    produced;
  * stale: each sort returns the output of the sort before it (for the
    window's first, the warm-up's last), as a graph replayed on the last
    request's buffers would.

A sort cell has no exchange between chips, so that fault has no case here.
"""

import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny


def unchanged(srt, ev, last):
    return lambda ct, span: ct


def half_left_out(srt, ev, last):
    def sort(ct, span):
        out = srt(ct, span)
        mask = np.zeros(out.slots)
        mask[: out.slots // 2] = 1.0
        return ev.mult(out, ev.make_plaintext(mask, out.level + (out.sdeg == 2), 1,
                                              slots=out.slots))
    return sort


def altered(srt, ev, last):
    def sort(ct, span):
        out = srt(ct, span)
        delta = np.zeros(out.slots)
        delta[1] = 0.5 / srt.srt.N
        return ev.add(out, ev.make_plaintext(delta, out.level, out.sdeg, slots=out.slots))
    return sort


def stale(srt, ev, last):
    prev = [last]

    def sort(ct, span):
        prev.append(srt(ct, span))
        return prev.pop(0)
    return sort


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered, stale], ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(root, fault):
    res, _ = harness.run_cell(tiny.CELL, 77, 0.05, False, time.perf_counter(), device="cpu",
                              root=root, fault=fault, log=lambda m: None)
    assert res["correct"] is False
    assert res["failed"] == res["attempted"] >= 1
    assert res["checks"]["max_abs_err"]["value"] > res["checks"]["max_abs_err"]["limit"]
