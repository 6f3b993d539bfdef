"""The generator: every seed sends the same sizes at the same times (one
fixed trace a mix), and the seed draws the token ids and the images."""
import numpy as np
import pytest

from portbench import traffic

MIX = {"prompt_len": {"dist": "loguniform", "lo": 256, "hi": 2048},
       "output_len": {"dist": "uniform", "lo": 32, "hi": 128}}
OPEN = {"gap": {"dist": "exponential", "rate": 6.5}}


def _flat(reqs):
    return [(p.tolist(), o) for p, o in reqs]


def test_lm_requests_repeat_for_a_seed_and_differ_across_seeds():
    a = traffic.lm_requests(MIX, 2**31 + 5, 64, 32064)
    assert _flat(a) == _flat(traffic.lm_requests(MIX, 2**31 + 5, 64, 32064))
    b = traffic.lm_requests(MIX, 2**31 + 6, 64, 32064)
    assert _flat(a) != _flat(b)
    # the same work: the same lengths in the same order, other token ids
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in b]
    assert all(not np.array_equal(p, q) for (p, _), (q, _) in zip(a, b))


def test_lengths_stay_in_their_ranges_and_each_block_holds_every_level():
    reqs = traffic.lm_requests(MIX, 3, 4 * traffic.BLOCK, 100)
    lens = [len(p) for p, _ in reqs]
    assert 256 <= min(lens) and max(lens) <= 2048
    assert all(32 <= o <= 128 for _, o in reqs)
    blocks = [sorted(lens[i:i + traffic.BLOCK]) for i in range(0, len(lens), traffic.BLOCK)]
    assert all(b == blocks[0] for b in blocks)
    assert all(0 <= int(p.min()) and int(p.max()) < 100 for p, _ in reqs)


@pytest.mark.parametrize("seconds", [10.0, 40.0])
def test_arrivals_are_due_inside_the_window_at_the_mix_rate(seconds):
    a = traffic.arrivals(OPEN, seconds)
    assert np.all(np.diff(a) > 0) and a[0] >= 0 and a[-1] < seconds
    assert abs(len(a) / seconds - 6.5) < 0.15 * 6.5
    assert np.array_equal(a, traffic.arrivals(OPEN, seconds))
    # a longer window starts with the same arrivals
    assert np.array_equal(a[:20], traffic.arrivals(OPEN, 2 * seconds)[:20])


def test_image_order_passes_over_the_whole_pool_each_time():
    o = traffic.image_order(5, 16, 40)
    assert sorted(o[:16]) == list(range(16)) and sorted(o[16:32]) == list(range(16))
    assert not np.array_equal(o, traffic.image_order(6, 16, 40))


def test_a_fixed_order_gives_every_seed_the_same_sizes_and_times():
    mix = dict(MIX, **OPEN)
    a = traffic.lm_requests(mix, 1, 40, 1000)
    b = traffic.lm_requests(mix, 2, 40, 1000)
    assert [(len(p), o) for p, o in a] == [(len(p), o) for p, o in b]
    assert [p.tolist() for p, _ in a] != [p.tolist() for p, _ in b]
