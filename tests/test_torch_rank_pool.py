"""The multi-rank tests' harness itself (tests/torch_parallel_jobs.py's
RankPool): a job reads only its own ranks' answers, and a job that fails
by time or by a dead rank leaves the pool with fresh rank processes.

Each test runs a pool of one rank (a restart spawns one process, which
keeps the test within seconds under the load of the fast subset's six
xdist workers) at a JOB_TIMEOUT_S of 1 s; the rank answers
``torch_parallel_jobs.answer``: (tag, rank, pid).
"""

import pytest
import torch

import torch_parallel_jobs as J

torch.set_num_threads(1)
TIMEOUT_S = 1.0


@pytest.fixture
def pool(tmp_path, monkeypatch):
    p = J.RankPool(1)
    # The rank warms up (its first job joins a group), so only a job's own
    # time counts against the short timeout below.
    assert [a[:2] for a in p.run(J.answer, 1, tmp_path, "warm")] == [("warm", 0)]
    monkeypatch.setattr(J, "JOB_TIMEOUT_S", TIMEOUT_S)
    yield p
    p.close()


def test_a_late_answer_never_reaches_the_next_job(pool, tmp_path):
    """A job whose rank answers after its timeout is followed by a second
    job: the second gets its own answer, from a rank started anew, never
    the first job's late one."""
    before = [p.pid for p in pool.procs]
    with pytest.raises(TimeoutError, match="did not answer"):
        pool.run(J.answer, 1, tmp_path, "late", 1.5 * TIMEOUT_S)
    got = pool.run(J.answer, 1, tmp_path, "next")
    assert [a[:2] for a in got] == [("next", 0)]
    fresh = [p.pid for p in pool.procs]
    assert not set(before) & set(fresh)
    assert [a[2] for a in got] == fresh


def test_a_dead_rank_fails_its_job_and_the_pool_starts_anew(pool, tmp_path):
    """A rank process that dies fails its job with its exit code (before the
    timeout runs out) and the next job runs on a fresh process."""
    before = [p.pid for p in pool.procs]
    with pytest.raises(TimeoutError, match=r"exited \{0: 3\}"):
        pool.run(J.answer, 1, tmp_path, "dies", 0.0, 0)
    assert not set(before) & {p.pid for p in pool.procs}
    got = pool.run(J.answer, 1, tmp_path, "next")
    assert [a[:2] for a in got] == [("next", 0)]
