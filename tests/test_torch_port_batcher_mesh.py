"""The planned ``DynamicBatcher``'s protocol (``serving.py``) and
``parallel.collectives.broadcast``, in a spawned world of 2 gloo ranks
(``test_torch_port_workers.batcher_cases``; no JAX in the workers). The
predictor is ``MeshStub``: it carries a plan over the ensemble axis and
``psum``s x·(rank + 1), so a call that some rank skips, or makes on other
rows, hangs or shows in the result (3·x on two ranks). Rank 0 is the front
and takes every request; rank 1 builds each batcher with the same arguments
and closes it twice. Every thread wait has its own timeout
(``workers.WAIT_S``)."""

import numpy as np
import pytest
import torch

from multimodal_eeg_fmri_tpu_torch import parallel as t_par

import test_torch_port_workers as workers

torch.set_num_threads(1)

WORLD = 2


@pytest.fixture(scope="module")
def ranks():
    out = t_par.spawn_local_world(workers.batcher_cases, WORLD)
    assert not any(jax_loaded for _, jax_loaded in out)
    return [r for r, _ in out]


def _same_on_every_rank(ranks, case):
    """The front's calls, counters and stop, on every rank alike."""
    front = ranks[0][case]
    for r, rank in enumerate(ranks):
        got = rank[case]
        assert got["seen"] == front["seen"], (r, case)
        assert (got["batches"], got["rows"]) == (front["batches"],
                                                front["rows"]), (r, case)
        assert not got["alive"], (r, case)
        assert got["close_s"] < workers.WAIT_S, (r, case)
    return front


def test_broadcast_round_trips_shapes_and_dtypes(ranks):
    for r, rank in enumerate(ranks):
        got, stop, refused = rank["broadcast"]
        assert stop is None
        assert list(got) == sorted(workers.BROADCAST_CASE), r
        for k, want in workers.BROADCAST_CASE.items():
            want = np.asarray(want)
            assert got[k].shape == want.shape and got[k].dtype == want.dtype
            assert got[k].flags.c_contiguous
            np.testing.assert_array_equal(got[k], want, err_msg=f"{r} {k}")
    assert "numeric arrays only" in ranks[0]["broadcast"][2]
    assert "'s': '<U1'" in ranks[0]["broadcast"][2]


def test_two_key_sets_in_one_flush_in_one_order(ranks):
    front = _same_on_every_rank(ranks, "keys")
    assert sorted(front["seen"]) == [(("a",), 2), (("b",), 2)]
    assert (front["batches"], front["rows"]) == (2, 4)
    for i in range(4):
        np.testing.assert_array_equal(front["got"][i], np.full((1, 2),
                                                               3.0 * i))


def test_multirow_request_flushed_at_the_deadline(ranks):
    front = _same_on_every_rank(ranks, "deadline")
    assert front["seen"] == [(("x",), 3)]
    assert (front["batches"], front["rows"]) == (1, 3)
    np.testing.assert_array_equal(
        front["got"], 3.0 * np.arange(6, dtype=np.float64).reshape(3, 2))


def test_errors_reach_the_front_and_the_worker_goes_on(ranks):
    """An error every rank raises goes to its caller; a group that cannot
    be joined goes back to its callers and never reaches the followers."""
    front = _same_on_every_rank(ranks, "errors")
    got = front["got"]
    assert got["boom"] == ("RuntimeError", "device fault")
    for i in range(2):
        assert got[i][0] == "ValueError" and "dimension" in got[i][1], got[i]
    np.testing.assert_array_equal(got["after"], np.full((2, 2), 6.0))
    # the failed call was made on every rank; the join error on none
    assert front["seen"] == [(("boom", "x"), 1), (("x",), 2)]
    assert (front["batches"], front["rows"]) == (1, 2)


def test_queue_full_and_timeout_as_unplanned(ranks):
    front = _same_on_every_rank(ranks, "queue")
    got = front["got"]
    assert got["full"] == (
        "DynamicBatcher queue full: 2 rows pending (max_queue=2); request "
        "of 1 row(s) rejected; retry later or raise max_queue")
    assert front["rejected"] == 1
    for k in ("held", "queued"):
        assert got[k][0] == "TimeoutError" and "timed out" in got[k][1]
    # the queued request was withdrawn; the held call ran on every rank
    assert got["left"] == 0 and not got["hung"]
    assert front["seen"] == [(("x",), 1), (("x",), 1)]
    np.testing.assert_array_equal(got["after"], np.full((1, 2), 9.0))
    assert [r["queue"]["rejected"] for r in ranks[1:]] == [0]


def test_follower_call_raises_and_close_stops_every_rank(ranks):
    front = _same_on_every_rank(ranks, "follower_call")
    assert front["got"] is None and front["batches"] == 0
    kind, msg = ranks[1]["follower_call"]["got"]
    assert kind == "RuntimeError"
    assert msg == ("rank 1 follows a planned DynamicBatcher: its front, "
                   "global rank 0, takes the requests")
    assert ranks[0]["closed"] == ("RuntimeError", "DynamicBatcher is closed")


def test_failed_broadcast_stops_every_rank(ranks):
    """A failed broadcast is not caught and carried on: the front's caller
    gets its error, later calls raise, the workers stop without a call and
    ``close()`` raises it on every rank, each time."""
    got = ranks[0]["broken"]["got"]
    assert got["first"] == ("ConnectionError", "the group failed")
    assert got["later"] == ("RuntimeError", "DynamicBatcher is closed")
    for rank in ranks:
        rec = rank["broken"]
        assert rec["seen"] == [] and not rec["alive"]
        assert rec["closes"] == [("RuntimeError", "the DynamicBatcher's "
                                  "broadcast failed")] * 2
        assert rec["cause"] == "ConnectionError('the group failed')"


def test_world_of_one_runs_the_planned_mode():
    """A plan of a world of one with a process group is planned (its
    broadcasts run on a group of one) and serves each request's rows."""
    ((got, counters, grouped, seen, jax_loaded),) = t_par.spawn_local_world(
        workers.batcher_world_of_one, 1)
    assert grouped and not jax_loaded
    x = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(np.concatenate(got), x)
    assert counters == (2, 5) and seen == [(("x",), 3), (("x",), 2)]
