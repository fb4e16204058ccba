import numpy as np

from harness import traffic

BIG = 3_000_000_017  # seeds past 32 bits


def _stream(spec, seed, n=300, vocab=1000):
    return traffic.RequestStream(spec, vocab, seed, "offline").take(n)


OFFLINE = {"mix_seed": 0, "prompt": {"median": 256, "sigma": 0.6, "min": 64, "max": 1024},
           "output": {"min": 256, "max": 768}}


def test_requests_repeat_per_seed_and_stay_in_range():
    a, b = _stream(OFFLINE, BIG), _stream(OFFLINE, BIG)
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1] for x, y in zip(a, b))
    assert all(64 <= len(p) <= 1024 and 256 <= n <= 768 for p, n in a)
    assert all(p.dtype == np.int32 and p.min() >= 0 and p.max() < 1000 for p, _ in a)


def test_seeds_share_the_sizes_in_another_order():
    a, b = _stream(OFFLINE, BIG, 256), _stream(OFFLINE, BIG + 1, 256)
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(n for _, n in a) == sorted(n for _, n in b)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]


def test_uniform_lengths_cover_their_range():
    g = np.random.default_rng(0)
    x = traffic.draw_lengths({"min": 16, "max": 128}, 5000, g)
    assert x.min() == 16 and x.max() == 128


def test_arrivals_offer_the_same_load_on_every_seed():
    a = traffic.arrivals(10.0, 50.0, 1, BIG)
    b = traffic.arrivals(10.0, 50.0, 1, BIG + 5)
    assert np.all(np.diff(a) > 0) and np.isclose(a[-1], b[-1])
    assert not np.allclose(a, b)
    assert np.array_equal(a, traffic.arrivals(10.0, 50.0, 1, BIG))
    # 500 would be due at 10/s over 50 s; the last of them at 50 s is not
    assert len(a) == len(b) == 499 and np.isclose(a[-1], 49.9) and a[-1] < 50.0


def test_a_window_holds_the_same_arrivals_on_every_seed():
    # the same number of requests, the same gaps, each seed in its own order
    for seconds in (3.0, 51.0, 7.3):
        xs = [traffic.arrivals(12.8, seconds, 0, s) for s in (BIG, BIG + 1, 7)]
        assert len({len(x) for x in xs}) == 1 and len(xs[0]) == int(12.8 * seconds)
        gaps = [np.sort(np.diff(x, prepend=0.0)) for x in xs]
        assert all(np.allclose(g, gaps[0]) for g in gaps)
        assert all(x[-1] < seconds for x in xs)
    w = traffic.arrivals(12.8, 51.0, 0, BIG)
    assert np.isclose(len(w) / w[-1], 12.8)  # the mix's rate, exactly
    assert not np.allclose(traffic.arrivals(12.8, 51.0, 0, BIG, 1), w)
    assert len(traffic.arrivals(0.1, 5.0, 0, BIG)) == 0


def test_train_batches_are_distinct_rows_shifted_by_one():
    bs = traffic.train_batches(5000, 4, 64, 3, BIG)
    again = traffic.train_batches(5000, 4, 64, 3, BIG)
    rows = np.concatenate([b["inputs"] for b in bs])
    assert len({r.tobytes() for r in rows}) == 12
    for b, c in zip(bs, again):
        assert np.array_equal(b["inputs"], c["inputs"])
        assert np.array_equal(b["inputs"][:, 1:], b["labels"][:, :-1])
        assert b["inputs"].shape == (4, 64) and b["inputs"].dtype == np.int32


def test_the_run_seed_orders_the_whole_stream():
    # nothing is pinned to a position: each seed puts the bursts and the
    # sizes where it will, over the whole schedule
    x = traffic.arrivals(10.0, 50.0, 1, BIG)
    y = traffic.arrivals(10.0, 50.0, 1, BIG + 5)
    assert np.mean(np.isclose(x, y)) < 0.05
    assert np.isclose(x[-1], y[-1])
    a = traffic.RequestStream(OFFLINE, 1000, BIG, "online", block=500).take(500)
    b = traffic.RequestStream(OFFLINE, 1000, BIG + 1, "online", block=500).take(500)
    assert sorted(len(p) for p, _ in a) == sorted(len(p) for p, _ in b)
    assert sorted(len(p) for p, _ in a[:64]) != sorted(len(p) for p, _ in b[:64])
