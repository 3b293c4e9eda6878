"""The traffic is a function of the seed: the same seed gives the same
utterances, every seed the same set of durations and transcript lengths."""

import numpy as np
import torch

from portbench import feed, traffic

MIX = {"utterances": 12, "seconds": [2.0, 30.0], "tokens_per_second": 3.5, "burst_duty": 0.3}


def test_same_seed_same_traffic():
    a, b = traffic.utterances(MIX, 2 ** 31 + 7, "cpu"), traffic.utterances(MIX, 2 ** 31 + 7, "cpu")
    assert [u.key for u in a] == [u.key for u in b]
    for x, y in zip(a, b):
        assert x.text == y.text
        diff = np.flatnonzero(x.samples != y.samples)
        assert diff.size == 0, (x.key, diff[:5], x.samples[diff[:5]], y.samples[diff[:5]], diff.size)


def test_seeds_share_sizes_not_order():
    a, b = traffic.utterances(MIX, 1, "cpu"), traffic.utterances(MIX, 2, "cpu")
    assert sorted(len(u.samples) for u in a) == sorted(len(u.samples) for u in b)
    assert sorted(len(u.text) for u in a) == sorted(len(u.text) for u in b)
    assert [len(u.samples) for u in a] != [len(u.samples) for u in b]
    assert not np.array_equal(a[0].samples[:400], b[0].samples[:400])


def test_durations_are_log_uniform_quantiles():
    d = np.sort(traffic.durations(4, 1.0, 16.0, np.random.default_rng(0)))
    np.testing.assert_allclose(d, [2 ** 0.5, 2 ** 1.5, 2 ** 2.5, 2 ** 3.5])


def test_transcripts_have_their_token_count():
    rng = np.random.default_rng(0)
    for n in (1, 7, 35, 104):
        t = traffic.transcript(n, rng)
        assert len(t) == n and t == t.strip() and t.islower()


def test_warm_first_puts_each_bucket_first():
    mix = dict(MIX, utterances=40, warm_first=True, bucket_seconds=7.68)
    utts = traffic.utterances(mix, 3, "cpu")
    buckets = [int(u.seconds // 7.68) for u in utts]
    n = len(set(buckets))
    assert sorted(buckets[:n]) == sorted(set(buckets))


def test_probe_labels_follow_the_bursts():
    samples, burst = traffic.probe(5, "cpu")
    frames = samples.numpy().astype(np.float64)
    energy = [np.abs(frames[960 * t + 100: 960 * t + 300]).mean() for t in range(len(burst))]
    loud = np.asarray(energy) > 300
    assert (loud == burst.numpy()).mean() > 0.8


def test_reference_batches_follow_the_budget():
    utts = traffic.utterances(dict(MIX, utterances=30), 4, "cpu")
    recipe = {"dataset_config": {"prompt_style": "<|im_start|>user\n{}<speech><|im_end|>\n"}}
    batches = feed.reference_batches(utts, recipe, 3000, 1)
    assert sum(len(b) for b in batches) == 30
    assert [k for b in batches for k in b] == [u.key for u in utts]


def test_utterance_waveforms_are_int16():
    u = traffic.utterances(dict(MIX, utterances=2), 9, "cpu")[0]
    assert u.samples.dtype == np.int16 and torch.as_tensor(u.samples).abs().max() > 1000
