"""Each committed configuration, at its committed size, through its
architecture module (``spec.architecture``): the leaves and the counts
that the metrics divide by, equal to literals computed before the
architecture moved behind the configuration's ``reference`` key (then
``weights.leaves``, ``counts._n_mixers`` and ``counts``' model-level
functions).  A change that moves one of them changes what a metric reads
in every later check."""

import hashlib
import json

import pytest

from benchlib import spec, traffic

#: sha256 of the JSON list of each leaf's [path, shape, dtype, init,
#: scale], in order, and the number of leaves.
LEAVES = {
    "mixtral-8x22b-1of56": (
        13, "417838308f1b185325f2fab686ebae850fd9ddfa47be126e1089a00964689fbe"),
    "mixtral-8x22b-8of56": (
        83, "19f3802fa98cd2342ab97181331577464b78966a35b3752a6ce55114b4ab53b8"),
    "mamba2-370m": (
        434, "dedd8ef40a7087187feb6c615fc26673b8f2e6cc312be18cd40118a6c00bf9f7"),
}
MIXERS = {
    "mixtral-8x22b-1of56": {"attn": 1, "mamba": 0},
    "mixtral-8x22b-8of56": {"attn": 8, "mamba": 0},
    "mamba2-370m": {"attn": 0, "mamba": 48},
}
#: train_flops at 2 x 8192 and at 8 x 4096.
TRAIN_FLOPS = {
    "mixtral-8x22b-1of56": [92314684882944.0, 179681567440896.0],
    "mixtral-8x22b-8of56": [603221781381120.0, 1166861144162304.0],
    "mamba2-370m": [40002436202496.0, 80004872404992.0],
}
#: At the serve mix's prompt lengths (299 ... 2630), 8 rows: prefill_flops
#: of the prompt and decode_bytes with the new token at that position.
PREFILL_FLOPS = {
    "mixtral-8x22b-1of56": [
        3323073331200.0, 4537719717888.0, 6201886900224.0, 8464976117760.0,
        11581364502528.0, 15847040483328.0, 21719316430848.0,
        29807840133120.0],
    "mixtral-8x22b-8of56": [
        26562566553600.0, 36279737647104.0, 49593075105792.0,
        67697788846080.0, 92628895924224.0, 126754303770624.0,
        173732511350784.0, 238440700968960.0],
    "mamba2-370m": [
        1693586448384.0, 2307914661888.0, 3160554086400.0, 4315406327808.0,
        5890118811648.0, 8022898581504.0, 10951740948480.0,
        14946778890240.0],
}
DECODE_BYTES = {
    "mixtral-8x22b-1of56": [
        5411377152.0, 5414948864.0, 5419831296.0, 5426450432.0,
        5435527168.0, 5447880704.0, 5464756224.0, 5487759360.0],
    "mixtral-8x22b-8of56": [
        40537731072.0, 40566304768.0, 40605364224.0, 40658317312.0,
        40730931200.0, 40829759488.0, 40964763648.0, 41148788736.0],
    "mamba2-370m": [736702464.0] * 8,
}
CONFIGS = sorted(LEAVES)


def _arch(name):
    cfg = spec.config(name)
    return cfg, spec.architecture(cfg)


def test_the_committed_configurations_are_these():
    assert sorted(c["name"] for c in spec.benchmark()["configs"]) == CONFIGS
    assert traffic.serve_lengths(spec.traffic("serve-grouped")) == [
        299, 408, 557, 759, 1036, 1413, 1928, 2630]


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_frozen(name):
    cfg, arch = _arch(name)
    leaves = arch.leaves(cfg)
    canon = json.dumps([[list(x.path), list(x.shape), x.dtype, x.init,
                         x.scale] for x in leaves])
    assert (len(leaves), hashlib.sha256(canon.encode()).hexdigest()) == (
        LEAVES[name])


@pytest.mark.parametrize("name", CONFIGS)
def test_mixers_are_frozen(name):
    cfg, arch = _arch(name)
    assert arch.mixers(cfg) == MIXERS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_train_flops_are_frozen(name):
    cfg, arch = _arch(name)
    assert [arch.train_flops(cfg, 2, 8192),
            arch.train_flops(cfg, 8, 4096)] == TRAIN_FLOPS[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_flops_and_decode_bytes_are_frozen(name):
    cfg, arch = _arch(name)
    lengths = traffic.serve_lengths(spec.traffic("serve-grouped"))
    assert [arch.prefill_flops(cfg, 8, n) for n in lengths] == (
        PREFILL_FLOPS[name])
    assert [arch.decode_bytes(cfg, 8, n) for n in lengths] == (
        DECODE_BYTES[name])
