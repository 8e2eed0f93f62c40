"""The traffic generators: every mix is deterministic from the seed, and
every seed gets the same sizes in the same order."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pbcore.reftrain import batch
from pbcore.traffic import ServeTraffic, quantile_sizes

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def load(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def mixes(kind):
    return sorted(p.stem for p in TRAFFIC.glob("*.json")
                  if load(p.stem)["kind"] == kind)


MIXES = mixes("serve")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = load(name)
    a, b = ServeTraffic(mix, 1000, 2**33 + 7), ServeTraffic(mix, 1000,
                                                            2**33 + 7)
    for i in (0, 1, len(a) - 1):
        ra, rb = a.request(i), b.request(i)
        assert np.array_equal(ra.prompt, rb.prompt)
        assert ra.new_tokens == rb.new_tokens


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_the_sizes(name):
    mix = load(name)
    a, b = ServeTraffic(mix, 1000, 3), ServeTraffic(mix, 1000, 4)
    assert list(a.user_lens) == list(b.user_lens)
    assert list(a.new_lens) == list(b.new_lens)
    assert len(set(a.user_lens[:64])) > 32
    assert not np.array_equal(a.request(0).prompt[-8:],
                              b.request(0).prompt[-8:])


@pytest.mark.parametrize("name", MIXES)
def test_requests_fit_the_mix(name):
    mix = load(name)
    t = ServeTraffic(mix, 1000, 5)
    for i in range(0, len(t), 97):
        r = t.request(i)
        assert len(r.prompt) + r.new_tokens <= mix["max_len"]
        assert r.prompt.min() >= 0 and r.prompt.max() < 1000
        assert mix["new_tokens"]["min"] <= r.new_tokens <= \
            mix["new_tokens"]["max"]
    warm = t.warmup(4)
    for r in warm:
        assert len(r.prompt) + r.new_tokens <= mix["max_len"]
        head = r.prompt[:mix["system_len"]]
        assert all(not np.array_equal(head, s) for s in t.systems)


def test_quantiles_follow_the_distribution():
    sizes = quantile_sizes({"dist": "lognormal", "median": 256,
                            "sigma": 0.8, "min": 32, "max": 1536}, 1001)
    assert sizes[500] == 256 and min(sizes) >= 32 and max(sizes) <= 1536
    flat = quantile_sizes({"dist": "uniform", "min": 64, "max": 512}, 449)
    assert flat == list(range(64, 513))


@pytest.mark.parametrize("name", mixes("train"))
def test_training_batches_follow_the_seed(name):
    """A step's batch is the same for the same seed and step, and every
    row of the first steps differs; labels are the next tokens."""
    mix = load(name)
    rows, seq = mix["batch"], 64
    a = batch(2**33 + 7, 1, rows, seq, 1000, "cpu")
    assert torch.equal(a["tokens"], batch(2**33 + 7, 1, rows, seq, 1000,
                                          "cpu")["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    firsts = torch.cat([batch(2**33 + 7, i, rows, seq, 1000, "cpu")
                        ["tokens"] for i in range(mix["checked_steps"])])
    assert len({tuple(r.tolist()) for r in firsts}) == len(firsts)
    other = batch(2**33 + 8, 1, rows, seq, 1000, "cpu")["tokens"]
    assert not torch.equal(a["tokens"], other)
