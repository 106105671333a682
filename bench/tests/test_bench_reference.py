"""At smoke widths on the CPU: the plain reference agrees with the port
(float32 on both sides), its lower-precision control fails the cells'
committed limits, and a run whose timed path is broken underneath comes
out not correct: a step that returns its state unchanged, half of the
batch left out (the mean taken over the rest), served tokens altered where
they are produced.  (The exchange between chips does not exist in a
one-chip cell.)"""

import copy

import pytest
from bench_tiny import MOE, SERVE, SSM, TRAIN, ctx

from benchlib import cli, compare, reference, spec
from benchlib.drivers import serve_grouped, train

TRAIN_CELL = {"moe": "mixtral-8x22b.train-8k", "ssm": "mamba2-370m.train-4k"}
SERVE_CELL = "mixtral-8x22b.serve-grouped"
CONTROL = "int8"
CFGS = {"moe": MOE, "ssm": SSM}


def _line(out, cell):
    bench = spec.benchmark()
    return cli.result(bench, spec.workload(bench, cell), out, False,
                      spec.limits(cell), ctx(MOE, TRAIN).device)


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_the_reference_trains_as_the_port_does(family):
    out = train.run(ctx(CFGS[family], TRAIN))
    assert all(v < 1e-5 for v in out.numbers.values()), out.numbers
    assert _line(out, TRAIN_CELL[family])["correct"] is True


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_the_control_fails_the_train_limits(family):
    cfg = CFGS[family]
    ref = reference.train_readings(cfg, TRAIN, 11, ctx(cfg, TRAIN).device)
    low = reference.train_readings(cfg, TRAIN, 11, ctx(cfg, TRAIN).device,
                                   lowp=CONTROL)
    checks = compare.held(compare.train_numbers(low, ref),
                          spec.limits(TRAIN_CELL[family]))
    assert not compare.correct(checks), checks


def _unchanged(step):
    def f(state, batch):
        _, metrics = step(copy.deepcopy(state), batch)
        return state, metrics
    return f


def _half_batch(step):
    def f(state, batch):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return f


@pytest.mark.parametrize("family", ["moe", "ssm"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(family, fault):
    out = train.run(ctx(CFGS[family], TRAIN), step=fault)
    assert _line(out, TRAIN_CELL[family])["correct"] is False


def test_serving_agrees_and_the_control_does_not():
    """At smoke width the control's readings (mean gap 0.07-0.16, miss
    share 0.3-0.5 over seeds) stay under the cell's limits, which were set
    from its readings at the cell's own size on the chip (0.38-0.55 and
    0.64-0.74); here it has to read far above the program, which agrees
    with the reference exactly."""
    cfg = dict(MOE, vocab_size=32768, n_layers=8, n_experts=8)
    c = ctx(cfg, dict(SERVE, gen=16, check_requests=8), seed=3)
    *_, batches, _, _, _ = serve_grouped.program(c)
    numbers = serve_grouped.check(c, batches, lowp_too=CONTROL)
    assert compare.correct(compare.held(numbers, spec.limits(SERVE_CELL)))
    assert numbers["logit_gap.mean"] == numbers["miss_share"] == 0.0
    assert numbers["control.logit_gap.mean"] > 0.05
    assert numbers["control.miss_share"] > 0.2


def test_altered_tokens_are_not_correct():
    def alter(tokens):
        return (tokens + 1) % MOE["vocab_size"]

    out = serve_grouped.run(ctx(MOE, SERVE), alter=alter)
    assert _line(out, SERVE_CELL)["correct"] is False
    assert _line(serve_grouped.run(ctx(MOE, SERVE)), SERVE_CELL)["correct"]
