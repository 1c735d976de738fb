"""The closed loop's accounting (attempted, answered, missing, latencies,
flush sizes) and the answer sample, against stub systems on the CPU."""
import time

import pytest
import torch

from benchlib.loop import Sampler, closed_loop

CPU = torch.device("cpu")


class Stub:
    """A batcher that answers ``2 x``, ``max_batch`` at a time; ``drop``
    leaves the second half of each flush unanswered."""

    def __init__(self, max_batch=32, drop=False, delay_s=0.0):
        self.max_batch, self.drop, self.delay_s = max_batch, drop, delay_s
        self.queue, self.next = [], 0

    @property
    def pending(self):
        return len(self.queue)

    def submit(self, x):
        rid = self.next
        self.next += 1
        self.queue.append((rid, x))
        return rid

    def flush(self):
        batch, self.queue = (self.queue[:self.max_batch],
                             self.queue[self.max_batch:])
        if self.delay_s:
            time.sleep(self.delay_s)
        keep = batch[:max(1, len(batch) // 2)] if self.drop else batch
        return {rid: 2 * x for rid, x in keep}


def draw_fn(n=8):
    g = torch.Generator().manual_seed(0)
    return lambda: torch.randn(n, generator=g)


def test_full_batches_and_counts():
    res = closed_loop(Stub(), draw_fn(), clients=64, device=CPU,
                      max_flushes=10)
    # 64 first requests, then 32 again after each of the first 9 answers
    assert res.attempted == 64 + 9 * 32
    assert res.flush_ks == [32] * 11
    assert res.answered == 10 * 32
    assert len(res.latencies_s) == res.answered
    assert res.missing == 0
    assert all(t >= 0 for t in res.latencies_s)
    assert res.drain_s >= res.window_s > 0


def test_one_client_is_one_request_a_flush():
    res = closed_loop(Stub(), draw_fn(), clients=1, device=CPU,
                      max_flushes=25)
    assert res.flush_ks == [1] * 25
    assert res.answered == res.attempted == 25


def test_time_window_closes_at_its_length():
    res = closed_loop(Stub(delay_s=0.002), draw_fn(), clients=4, device=CPU,
                      seconds=0.1)
    assert res.window_s == pytest.approx(0.1)
    assert 0 < res.answered <= res.attempted
    # answers that came after the close are not counted, nor lost
    assert res.missing == 0
    assert max(res.latencies_s) < 0.1


def test_unanswered_tickets_count_as_missing():
    res = closed_loop(Stub(drop=True), draw_fn(), clients=8, device=CPU,
                      max_flushes=3)
    assert res.missing == sum(k - max(1, k // 2) for k in res.flush_ks)
    assert res.answered + res.missing == res.attempted


def test_flush_that_takes_nothing_is_an_error():
    class Stuck(Stub):
        def flush(self):
            return {}
    with pytest.raises(RuntimeError, match="took no queued request"):
        closed_loop(Stuck(), draw_fn(), clients=2, device=CPU,
                    max_flushes=1)


def test_sampler_is_uniform_bounded_and_copies():
    s = Sampler(4, 7, (3, 3), CPU)
    ys = [torch.full((3,), float(i)) for i in range(100)]
    for y in ys:
        s.offer(y, y)
    assert s.seen == 100 and len(s.items) == 4
    picked = sorted(int(y[0]) for _, y in s.items)
    ys[picked[0]].fill_(-1.0)           # a later write to the answer
    assert sorted(int(y[0]) for _, y in s.items) == picked
    again = Sampler(4, 7, (3, 3), CPU)
    for i in range(100):
        y = torch.full((3,), float(i))
        again.offer(y, y)
    assert [int(x[0]) for x, _ in again.items] == [
        int(x[0]) for x, _ in s.items]


def test_malformed_answers_are_counted_not_kept():
    s = Sampler(4, 7, (3, 3), CPU)
    s.offer(torch.ones(3), torch.ones(2))
    s.offer(torch.ones(3), torch.ones(3))
    assert s.malformed == 1 and s.seen == 1 and len(s.items) == 1


def test_sample_covers_the_answers_of_a_loop():
    s = Sampler(16, 1, (8, 8), CPU)
    closed_loop(Stub(), draw_fn(), clients=64, device=CPU, max_flushes=4,
                sampler=s)
    assert len(s.items) == 16
    for x, y in s.items:
        torch.testing.assert_close(y, 2 * x)
