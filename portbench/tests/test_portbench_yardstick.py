"""The yardstick against hand counts, and the window's rates and tails."""
import math
import types

import pytest

from portbench import harness, yardstick as y

ALEXNET = harness._json(harness.HERE / "configs" / "alexnet.json")
PHI3 = harness._json(harness.HERE / "configs" / "phi3-medium-14b.json")


def test_percentile_is_nearest_rank_and_counts_misses():
    xs = [float(i) for i in range(1, 101)]
    assert y.percentile(xs, 95) == 95.0
    assert y.percentile(xs, 50) == 50.0
    # six misses of a hundred put the 95th percentile on a miss
    assert y.percentile(xs[:94] + [math.inf] * 6, 95) == math.inf
    assert y.percentile(xs[:95] + [math.inf] * 5, 95) == 95.0
    assert math.isnan(y.percentile([], 95))


def test_bound_takes_the_larger_term_at_the_published_peaks():
    b = y.bound_ms(989e9, 1.0, bf16=True)
    assert b.by == "ops" and b.ms == pytest.approx(1.0)
    b = y.bound_ms(1.0, 3.35e9, bf16=False)
    assert b.by == "bytes" and b.ms == pytest.approx(1.0)
    assert y.bound_ms(67e9, 0, bf16=False).ms == pytest.approx(1.0)


def test_alexnet_stages_and_flops_by_hand():
    st = y.cnn_stages(ALEXNET)
    # 224 -> 54 (11, s4) -> pool 27 -> 23 -> pool 11 -> 9 -> 7 -> 5 -> pool 2
    assert st == [(54 * 54, 3 * 121, 96, 27 * 27), (23 * 23, 96 * 25, 256, 11 * 11),
                  (9 * 9, 256 * 9, 384, 81), (7 * 7, 384 * 9, 384, 49),
                  (5 * 5, 384 * 9, 256, 4)]
    hand = 2 * (2916 * 363 * 96 + 529 * 2400 * 256 + 81 * 2304 * 384 + 49 * 3456 * 384
                + 25 * 3456 * 256) + 2 * 1024 * 1000
    assert y.cnn_flops_per_image(ALEXNET) == hand
    assert 256 * 2 * 2 == ALEXNET["features"]


def test_k1_bytes_by_hand():
    # bf16 x (4, 5120), int4 (5120, 17920), one 16-entry f32 dictionary, f32 out
    assert y.k1_bytes(4, 5120, 17920, x_bytes=2, idx_bits=4) == (
        4 * 5120 * 2 + 5120 * 17920 // 2 + 64 + 4 * 17920 * 4)
    # f32 patches, uint8 indices, a pooled output and the bias
    assert y.k1_bytes(16, 363, 96, x_bytes=4, idx_bits=8, out_rows=4, bias=True) == (
        16 * 363 * 4 + 363 * 96 + 64 + 4 * 96 * 4 + 96 * 4)


def test_phi3_counts_by_hand():
    per_layer = 5120 * 5120 * 2 + 2 * 5120 * 1280 + 3 * 5120 * 17920
    assert y.lm_linear_params(PHI3) == 40 * per_layer
    head = 2 * 5120 * 32064
    attn = lambda pairs: 40 * 4 * 40 * 128 * pairs  # noqa: E731
    assert y.lm_prefill_flops(PHI3, 3) == 2 * 3 * 40 * per_layer + attn(6) + head
    assert y.lm_decode_flops(PHI3, 100) == 2 * 40 * per_layer + attn(100) + head
    launches = y.lm_k1_launches(PHI3, 512, 1)
    assert len(launches) == 7 * 40 + 1 and launches[-1] == (1, 5120, 32064)
    assert launches[0] == (512, 5120, 5120) and launches[6] == (512, 17920, 5120)


def _run(**kw):
    r = types.SimpleNamespace(t0=10.0, t1=12.5, counters={}, requests=[], profile=None,
                              cfg=ALEXNET)
    r.__dict__.update(kw)
    r.window_s = r.t1 - r.t0
    return r


def test_window_rates_are_all_the_work_over_all_the_window():
    run = _run(counters={"images": 1000, "batches": 16, "tokens": 500})
    assert harness._reader("img_per_s")(run) == pytest.approx(400.0)
    assert harness._reader("tok_per_s")(run) == pytest.approx(200.0)
    assert harness._reader("cnn_batch_imgs")(run) == pytest.approx(62.5)
    assert harness._reader("mfu.cnn")(run) == pytest.approx(
        100 * 400 * y.cnn_flops_per_image(ALEXNET) / 67e12)


def test_ttft_p85_counts_failed_requests_as_misses():
    ok = [{"due": 0.0, "first": i / 1000, "failed": False} for i in range(1, 86)]
    bad = [{"due": 0.0, "first": math.nan, "failed": True}] * 15
    read = harness._reader("ttft_p85_ms")
    assert read(_run(requests=ok + bad)) == pytest.approx(85.0)
    assert read(_run(requests=ok[:84] + bad + bad[:1])) == 1e12


def test_idle_share_reads_the_traced_window():
    run = _run(profile={"busy_s": 0.75, "window_s": 3.0})
    assert harness._reader("idle.cnn")(run) == pytest.approx(75.0)
    assert harness._reader("idle.serve")(_run()) is None


@pytest.mark.parametrize("name", sorted(m["name"] for m in harness.manifest()["per_layer"]
                                        if m["name"].startswith(("idle.", "decode_ms.",
                                                                 "prefill_ms_per_ktok."))))
def test_a_metric_without_a_reader_of_its_own_reads_with_its_stems(name):
    stem = name.split(".")[0]
    assert not (harness.HERE / "metrics" / f"{name}.py").exists()
    assert harness.reader_path(name) == harness.HERE / "metrics" / f"{stem}.py"
    spans = harness.Spans(False, False)
    spans.items = [("decode", 10.5, 10.75, {}), ("decode", 11.0, 11.5, {}),
                   ("prefill", 11.5, 12.0, {"n": 2000})]
    run = _run(profile={"busy_s": 2.25, "window_s": 3.0}, spans=spans)
    want = {"idle": 25.0, "decode_ms": 375.0, "prefill_ms_per_ktok": 250.0}[stem]
    assert harness._reader(name)(run) == pytest.approx(want)


def test_a_reader_of_its_own_comes_before_its_stems():
    assert harness.reader_path("mfu.cnn").name == "mfu.cnn.py"
    assert harness.reader_path("k1_roofline.train").name == "k1_roofline.train.py"
