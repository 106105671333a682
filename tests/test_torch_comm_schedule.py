"""The port's step-DAG plan and its copies of the numpy simulator and the
policies, against the reference package, on the CPU.

``repro_torch.core.{simulator,sched,metaflow,fabric}`` are the reference's
modules with the port's imports, so every simulation equals the
reference's exactly: JCT, CCT and the metaflow service order, for every
registered scenario at its quick size, seeds 0-2, under all five policies,
with a straggler and a link failure on Figure 1, and under
``debug_checks`` on Figure 1.
``repro_torch.core.comm_schedule.plan_step_comm`` runs on those copies;
given the reference's TPU constants it gives the reference's plan exactly
for every registered arch at 2, 8 and 256 chips.  Under its own H100
defaults it keeps the properties the reference's ``TestStepPlan`` checks.
"""

import pytest

from repro.appdag import mixer as rmixer
from repro.configs import ARCH_NAMES
from repro.configs import get_config as rget_config
from repro.configs.base import LM_SHAPES as RSHAPES
from repro.core import FaultEvent as RFaultEvent
from repro.core import Perturbation as RPerturbation
from repro.core import available_policies as ravailable
from repro.core import make_scheduler as rmake
from repro.core import metaflow as rmetaflow
from repro.core import simulate as rsimulate
from repro.core.comm_schedule import plan_step_comm as rplan
from repro.roofline import analysis as rroofline
from repro_torch.appdag import mixer
from repro_torch.configs import get_config
from repro_torch.configs.base import LM_SHAPES
from repro_torch.core import (Fabric, available_policies, make_scheduler,
                               metaflow, simulate)
from repro_torch.core.comm_schedule import build_train_dag, plan_step_comm
from repro_torch.core.simulator import FaultEvent, Perturbation, Simulator
from repro_torch.models.transformer import n_units
from repro_torch.roofline import hw

TPU_V5E = hw.Chip(peak_flops=rroofline.PEAK_FLOPS, hbm_bw=rroofline.HBM_BW,
                  link_bw=rroofline.LINK_BW)
POLICIES = ("cpath", "fair", "fifo", "msa", "varys")


def _assert_runs_equal(got, want, what):
    assert got.jct == want.jct, what
    assert got.cct == want.cct, what
    assert got.mf_service_order == want.mf_service_order, what
    assert (got.makespan, got.events) == (want.makespan, want.events), what


def test_policy_registry_matches_reference():
    assert available_policies() == ravailable() == POLICIES


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario", list(rmixer.SCENARIOS))
def test_simulator_matches_reference(scenario, policy):
    for seed in range(3):
        rfab, rjobs = rmixer.build_scenario(scenario, seed=seed, quick=True,
                                            lint=False)
        fab, jobs = mixer.build_scenario(scenario, seed=seed, quick=True)
        _assert_runs_equal(simulate(jobs, make_scheduler(policy), fabric=fab),
                           rsimulate(rjobs, rmake(policy), fabric=rfab),
                           (scenario, seed, policy))


@pytest.mark.parametrize("policy", POLICIES)
def test_figure1(policy):
    got = simulate(metaflow.figure1_jobs(), make_scheduler(policy))
    want = rsimulate(rmetaflow.figure1_jobs(), rmake(policy))
    _assert_runs_equal(got, want, policy)
    if policy in ("msa", "varys"):
        assert got.avg_jct == {"msa": 7.0, "varys": 8.0}[policy]


@pytest.mark.parametrize("policy", ["msa", "varys"])
def test_faults_match_reference(policy):
    """The fabric copy's degrade and fail/repair state: a straggling port
    and a failed link on Figure 1."""
    got = simulate(metaflow.figure1_jobs(), make_scheduler(policy),
                   perturbations=[Perturbation(1.0, 0, 0.5),
                                  Perturbation(3.0, 0, None)],
                   faults=[FaultEvent(2.0, "fail_link", 4),
                           FaultEvent(4.0, "repair_link", 4)])
    want = rsimulate(rmetaflow.figure1_jobs(), rmake(policy),
                     perturbations=[RPerturbation(1.0, 0, 0.5),
                                    RPerturbation(3.0, 0, None)],
                     faults=[RFaultEvent(2.0, "fail_link", 4),
                             RFaultEvent(4.0, "repair_link", 4)])
    _assert_runs_equal(got, want, policy)
    assert (got.n_perturbations, got.n_faults, got.stall_s) == (
        want.n_perturbations, want.n_faults, want.stall_s)
    assert got.n_faults == 2


def test_debug_checks_are_not_ported():
    """The name predates the port's sanitizer: ``debug_checks=True`` now
    runs the port's invariant engine on every decision and changes no
    result (``tests/test_torch_analysis.py`` holds it to the reference's
    on the scenarios)."""
    for policy in POLICIES:
        got = Simulator(Fabric(n_ports=3), metaflow.figure1_jobs(),
                        make_scheduler(policy), debug_checks=True).run()
        want = rsimulate(rmetaflow.figure1_jobs(), rmake(policy),
                         debug_checks=True)
        _assert_runs_equal(got, want, policy)


@pytest.mark.parametrize("chips", [2, 8, 256])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_matches_reference(arch, chips):
    want = rplan(rget_config(arch), RSHAPES["train_4k"], chips=chips)
    got = plan_step_comm(get_config(arch), LM_SHAPES["train_4k"],
                         chips=chips, chip=TPU_V5E)
    assert got.order == want.order
    assert got.dag_steps == want.dag_steps
    assert got.bucket_bytes == want.bucket_bytes
    assert got.overlap_fraction == want.overlap_fraction


def test_h100_constants():
    assert hw.H100 == hw.Chip() == (989e12, 3.35e12, 450e9)
    assert (hw.PEAK_FLOPS, hw.FP32_FLOPS, hw.HBM_BW, hw.LINK_BW) == (
        989e12, 67e12, 3.35e12, 450e9)


class TestStepPlanOnH100:
    """The reference's ``TestStepPlan`` properties under the port's H100
    defaults."""

    @pytest.mark.parametrize("arch", ["qwen2-7b", "llama3-405b",
                                      "mixtral-8x22b"])
    def test_msa_no_worse_than_barrier(self, arch):
        plan = plan_step_comm(get_config(arch), LM_SHAPES["train_4k"])
        assert plan.dag_steps["msa"] <= plan.dag_steps["flat"] + 1e-9
        assert plan.dag_steps["msa"] <= plan.dag_steps["varys"] + 1e-9

    def test_order_is_permutation(self):
        cfg = get_config("qwen2-7b")
        plan = plan_step_comm(cfg, LM_SHAPES["train_4k"])
        assert sorted(plan.order) == list(range(n_units(cfg)))

    def test_msa_order_prioritizes_late_backward_units(self):
        cfg = get_config("qwen2-7b")
        plan = plan_step_comm(cfg, LM_SHAPES["train_4k"])
        assert plan.order[0] == n_units(cfg) - 1

    def test_overlap_reported(self):
        plan = plan_step_comm(get_config("llama3-405b"),
                              LM_SHAPES["train_4k"])
        assert 0.0 <= plan.overlap_fraction <= 1.0

    def test_flat_dag_gates_every_update_on_one_metaflow(self):
        cfg = get_config("qwen2-7b")
        job = build_train_dag(cfg, LM_SHAPES["train_4k"], flat=True)
        assert list(job.metaflows) == ["g_all"]
        assert all(t.deps == ["g_all"] for name, t in job.tasks.items()
                   if name.startswith("opt"))
